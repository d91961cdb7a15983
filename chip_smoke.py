#!/usr/bin/env python3
"""On-card check of the torch port: TPC-H, k-means, serving and training
Qwen2-1.5B (its train step also sharded over four ranks sharing the
card), serving Moonlight-16B-A3B, Mixtral-8x7B's widths, Qwen2-VL-7B,
Zamba2-7B and RWKV6-1.6B, serving and training Whisper-base, serving
StarCoder2-15B, GLM4-9B and Granite-34B whole, and training each family
at full width through ``repro_torch`` on one GPU.

    python3 chip_smoke.py [--sf 5] [--reps 5] [--profile]

Phases, each printing its own lines:

1. the card (``nvidia-smi`` name and power limit) and the build of the
   kernels built once (``fused_select_agg``, ``grouped_select_agg`` and
   ``grouped_join_agg`` are generated per query and built at their first
   call; their builds, reuses and nvcc seconds are printed after the edge
   cases, the TPC-H path and at the end);
2. each CUDA kernel against its plain PyTorch version on edge cases
   (empty selection, ragged capacity, out-of-domain and duplicate join
   keys, more buckets than shared memory holds, ``grouped_select_agg`` at
   the borders of its routes (reg, smem, global) and ``grouped_join_agg``
   on each, printing the route each took, a predicate deeper than the old
   interpreter's stack through both select kernels, and the generated
   kernels' fixed-order routes run twice for the same bits; for k-means
   ragged n, a d = 1 case at adversarial near-ties,
   n = 0, fewer points than a tile, k = 1, d = 3, the top of the
   tensor-core route's range and just past it, chunk views that start
   inside a 16-byte granule, duplicate and far centroids, centroid tables
   past 48 KB and past the opt-in shared memory, each printing the route it
   took; for segsum ids at K−1 and out of range, empty segments, d = 1 and
   d = 3 views that start mid-granule, accumulators past 48 KB and past the
   opt-in shared memory, each printing its route);
3. the TPC-H path: TPC-H at ``--sf`` (seed 0), the six queries through
   ``Frame.collect(device="cuda")``, each held against the numpy
   reference, with the kernels' launch counts and the generated kernels'
   routes read around that one run (Q1 on ``gsa_reg``, Q4's inner count
   on an atomic route, Q4's and Q12's join on ``gja_reg``); the path's
   calls on a fixed-order route run twice more, for the same bits; one
   pass under ``torch.profiler``, which must show the generated kernels
   (the join's build and probe among them) and no kernel of the old
   expression interpreter (``fsa_main``, ``fsa_finalize``, ``gsa_main``
   and the join's: every relational kernel a generated one); the ``grouped_select_agg`` wrapper's time of Q1 and Q4
   split into the generated launch, ``decode_bucket_keys`` and ``compact``,
   and the ``grouped_join_agg`` wrapper's of Q4 and Q12 into the build
   launch, the probe launch and the epilogue;
4. the k-means path: 2^24 points, d = 8, k = 16 (seed 0, made as
   ``examples/kmeans.py`` makes them), the program built with ``Builder``,
   then ``FuseKMeansStep`` and ``Parallelize(8)``, run on
   ``LocalBackend(use_kernels=True)`` for a warm-up and 5 steps,
   ``kmeans_step`` launched 8 times per step, every call on the
   tensor-core route (``kms_tc``, the route line); each step held against a
   numpy f64 step from the same centroids, and the unfused program against
   the fused one; one path call under ``torch.profiler``, which must show
   ``kms_tc`` and not ``kms_main``, then run twice more: the same bits;
5. ``segsum`` on the unfused program's ``la.SegSum`` inputs (the JAX
   package's emitters never call its segsum kernel either), counted alone,
   printing its route (``seg_tc``, checked, and under ``torch.profiler``
   ``seg_tc`` and not seg_main's ``fix_seg_*``), then run twice more: the
   same bits;
   then determinism: each route that adds f32 sums in no fixed order
   (``gsa_smem``, ``gsa_global``, ``gja_smem``, ``gja_global`` at 2^18
   rows and 1,000 or 750,000 buckets, ``kms_main`` at d = 64, k = 256,
   ``seg_main`` at d = 8, K = 100, the sorted tiers'
   ``runtime._segment_sum``), on an order-sensitive input and a random
   one, called twice: the same bits, its route launched; the sums bit
   for bit ``ref.fixed_sum``, kmeans_step's by the tie-margin rule;
6. the TPC-H path with ``parallel=4``: the six queries again, split into
   four chunks, against the references; Q1 and Q6 launch their kernel
   once per chunk; the route of every ``grouped_select_agg`` call; each
   kernel call of this path (chunk views, Q1's recombine, Q4's split inner
   aggregation) against its plain version;
7. the JAX package's default tiers: the six queries under
   ``groupby=sorted, join=sorted`` with ``use_kernels``, sequential and
   with ``parallel=4``, against the references (Q6, Q14 and Q19 launch
   ``fused_select_agg``, no query a grouped kernel); Q1 and Q12 under
   ``fuse=unfused``; per query the compile and execute ms of the sorted
   tiers beside the direct ones;
8. the plan cache: per query a fresh ``PlanCache``, the first collect (a
   miss) and ``--reps`` repeats (hits), each hit the miss's bits;
9. dictionary encoding: tests/test_dict_encoding.py's string group-by,
   sparse int group-by (300 keys over a 1.5e9 span) and string join with
   out-of-dictionary probes at 2^22 rows under ``encode=dict`` (the join
   also under ``join=sorted``), each against a numpy oracle, with its
   plan, the kernels and routes it launched;
10. SQL: TPC-H Q6 and a grouped ``ORDER BY … LIMIT 3`` through
   ``sql.query(ctx, ..., device="cuda")``: the Python frontend's program
   (the plan cache serves its plan), its bits, and numpy's answer;
11. the cost search: the six queries with ``optimize="cost"`` and a fresh
   ``PlanCache``, sequential and with ``parallel=4``, against the
   references: per query the chosen strategy of 16 candidates, the
   search's compile ms against the fixed path's miss compile, the chosen
   plan's execute ms against the default strategy's; then a fresh cache on
   a temporary ``PlanStore``: the second compile replays the stored
   strategy (``cache_source == "store"``), timed;
12. admission: the six queries under the port's tiers, the sorted tiers,
   ``encode=dict`` and ``fuse=unfused``, each admitted under the card's
   total memory, each estimate's peak bytes beside the caching
   allocator's measured rise, which must not exceed it; Q4 under a budget
   of the cheaper tier's largest estimate (the search keeps exactly the
   candidates the model admits) and under one below every candidate
   (rejected); a group-by of 2^16 rows over a 10^6-wide key domain under
   each tier (each rise within its estimate), and under a budget that
   drops its direct candidates, answered by a sorted plan as numpy does;
13. taps and feedback: the six queries under ``tracing()``, one observation
   per tapped operator, scans and the last aggregation measuring numpy's
   rows, traced ms beside plain ms; ``enable_auto_replan`` re-plans Q1
   compiled on stale statistics;
14. control flow: the k-means step as the body of ``cf.Loop(n=5)`` at the
   k-means path's shape, fused and split in 8, through the driver:
   ``kmeans_step`` launched 40 times on ``kms_tc``, the centroids the bits
   of five one-step calls; ``cf.Cond`` (both branches), ``cf.Call`` and
   ``df.Source → df.Collect`` against the CPU;
15. the fallback ladder: Q1 with ``backend.execute`` injected once (the
   ``groupby=sorted`` rung answers) and at every rung down to ``interp``
   (numpy on the host), each against the reference, with ms per rung;
   then a subprocess with an empty build directory and no ``nvcc``, whose
   ``collect()`` must raise ``KernelBuildError`` under ``guard=True``.
   Every other phase runs with ``DegradedWarning`` an error, so a step down
   the ladder anywhere else fails the run;
16. the stream target: lineitem at ``--sf`` from the host copy in
   micro-batches of 65,536 rows (``microbatches``), orders and part static
   on the card; Q1, Q6, Q12, Q14, Q19 and revenue per order (a
   GroupAggDirect state of one group per order, 750,000 at sf=5), each
   with its four segments, one counted fold (its kernel launched once a
   batch plus ``init_state``'s, on its route: ``gsa_reg``, ``fsa_gen``,
   ``gja_reg``, ``gsa_global``), the init, first and ragged last kernel
   calls against their plain versions, the answer against numpy (the
   revenue state against a numpy ``bincount`` in f64), fold rows/s
   (median of ``--reps`` after a warm-up) beside the batch path's, and ms
   per batch split into copy, batch segment and merge; Q1 under the
   sorted tiers (its batch face and its fold); Q4 must raise
   lower_stream's named error; Q1 and the revenue state with snapshots
   every 16 batches (ms, bytes, the checkpointed fold over the bare one);
   a ``stream.batch`` kill at batch 24 recovered by ``stream_loop`` and a
   second consumer restoring a dead one's snapshots (every query, the
   revenue state and the sorted Q1 give the uninterrupted fold's bits and
   numpy's answer); a ``grouped_select_agg`` that
   refuses mid-stream must raise ``KernelLaunchError`` out of
   ``stream_loop`` with no restore;
17. the spmd and multipod targets: four rank processes (spawned) sharing
   the card over a gloo group (a ``file://`` store, a 120 s timeout), each
   reading the tables the parent wrote as ``.npy`` files; first each
   collective probed on CUDA tensors (gloo must take all four, as
   ``backends/spmd.py`` hands them over unstaged); then on every rank the
   six queries with ``target="spmd"``, ``parallel=4`` (the counts set to 0
   just before and read just after; each rank launches its kernels on its
   chunk, checked against its routes), ``collectives=False`` (the local
   run's bits), Q1 and Q4 under ``grouped-recombine=exchange``, Q4 under
   ``optimize="cost"``, Q6 through ``ElasticExecutor`` at 4 → 2 → 4
   workers (the return a plan-cache hit), Q6 under an injected
   ``spmd.shard`` fault (a rung answers) and a k-means step at the
   k-means path's shape; every answer against numpy, the local run at
   ``parallel=4`` (rtol 1e-5) and the other ranks' (one digest), the
   k-means step against the local one by the tie-margin rule, rank 0's
   kernel calls against their plain versions; ms per query (median of 5
   calls, the card synchronised on every rank, then a barrier) beside the
   local run's, the collectives a query issues and ms per collective at the
   sizes the queries gave it, each labelled with the ranks, the card and
   gloo (none of it is multi-GPU scaling);
18. the serving path: Qwen2-1.5B (``configs/qwen2_1_5b.py`` ``CONFIG``, 28
   layers at full width, bf16, parameters from ``model.init`` with seed 0)
   with ``attn_mode="pallas"``, 8 requests of 2048 prompt tokens (made as
   ``launch/serve.py`` makes them) in waves of 4, 32 greedy tokens each,
   a cache of 2080, through ``launch.serve``'s ``make_run_wave`` and
   ``serve_loop`` after one warm-up wave; ``flash_attention`` launched 28
   times per wave; then the same parameters and prompts with the plain
   attention (``ref``, a batch row at a time) and with ``chunked``, each
   path held against the
   plain one; the kernel against its plain version on edge cases first
   (S ∈ {1, 77, 200, 2048}, D ∈ {32, 64, 128}, group ∈ {1, 6}, f32 on the
   CUDA-core kernel and bf16 on the tensor-core one, non-causal, windows
   64 and 128, a non-default scale; then D = 112 at S ∈ {1, 200, 2048},
   group ∈ {1, 4}, causal and windowed, f32 and bf16), each with its route,
   its share of the bound and, in bf16, its distance from the tensor-core
   recipe (``ref.flash_attention_tiled``);
19. the training path (``models.api.make_train_step``: ``lm_loss`` with
   the chunked CE loss, autograd through ``chunked_attention`` with remat,
   AdamW): ``attention(mode="pallas")`` must refuse under grad; Qwen2-1.5B's
   widths at depth 2 in f32 on the card against the same code in f64 on
   the host (B = 1, S = 512: the loss to rtol 1e-5, each gradient leaf by
   ‖Δ‖/‖g‖ ≤ 1e-3, TF32 off), ``remat=False`` against ``remat=True``
   (1e-6) and ``microbatch=2`` against 1 on B = 2 (loss 1e-5, gradients
   1e-4); then Qwen2-1.5B at full depth in bf16 (``model.init`` from seed
   0, AdamW lr 3e-3, B = 4, S = 2048, ``loss_chunk`` 512, the batch
   ``TokenPipeline(seed=0).batch_at(0)``), a warm-up step and 4 steps with
   the launch counts set to 0 just before and read just after (training
   launches none of the six kernels, as JAX's trainer launches no Pallas
   kernel): the loss finite and below the first step's, every parameter
   finite, step ms (median, synchronised), tokens/s, peak allocated GB
   (above what earlier phases hold; then one more step's loss-and-gradient
   part and AdamW update apart) and model-FLOPs share (6·N·tokens over
   989 TFLOP/s), with the card's name
   and power limit, and with ``--profile`` one step's device ms by the
   top operators; last ``launch/train.py`` at depth 2 in bf16: 3 steps
   with a checkpoint, the restored step-3 state the saved one bit for bit,
   3 resumed steps whose losses are the uninterrupted run's (rtol 2^-7);
20. the sharded train step: four rank processes (spawned) sharing the card
   over gloo run Qwen2-1.5B's full widths at 2 of its 28 layers (the
   cut: gloo copies every collective through the host) through
   ``frontends.tensor.lower_to_pjit`` over a (data 2 × model 2) mesh,
   B = 4, S = 2048, microbatch 2: the parameters placed by the sharding
   table as DTensors, ZeRO-1 moments, the ZeRO-2 f32 accumulator, the
   vocab-split CE (no all-gather of logits, checked); first the probe that
   gloo takes ``all_gather_into_tensor`` and ``reduce_scatter_tensor`` on
   CUDA tensors; in f32 the loss and each gradient leaf against the
   one-device step on rank 0 (rtol 1e-5, ‖Δ‖/‖g‖ ≤ 1e-5) and step 1's
   parameters by the update rule of ``tests/test_torch_train.py``; then a
   warm-up and 3 steps in f32 and in bf16 (losses finite, falling, the
   same on every rank; no kernel launched): step ms per rank, the
   collectives a step by kind (equal to the dry-run's of the same cut cell
   on a fake world of 4, checked) and peak GB per rank beside the
   dry-run's (the production cell's dry-run is the CLI's,
   ``python -m repro_torch.launch.dryrun``, run on its own); then the MoE
   over the same mesh: Moonlight-16B-A3B's widths at 1 of 48 layers in
   f32 (``sharding.per_rank_moe``: every rank routes the whole microbatch
   and computes its 16 experts), the loss and each gradient leaf against
   the one-device step (rtol 1e-5, ‖Δ‖/‖g‖ ≤ 1e-5), the dropped choices
   on every rank equal to the one-device step's, then a warm-up and 2
   AdamW steps: step ms, the collectives a step (equal to the dry-run's
   of the cut cell) and peak GB per rank; last the hybrid over the same
   mesh: Zamba2-7B's widths at 2 of 81 layers (the shared block at layer
   0), the Mamba2 mixer per rank (``sharding.per_rank_mamba``: in_proj's
   output gathered over model, 56 of 112 SSM heads a rank, the norm's sum
   of squares all-reduced); in f32 the loss and each gradient leaf against
   the one-device step on rank 0 (rtol 1e-5; each leaf within 1e-5 or 4×
   the one-device f32 step's own distance from its f64 step), then a
   warm-up and 2 timed bf16 AdamW steps (step ms, the collectives a step
   equal to the dry-run's of the cut cell, peak GB per rank); then the
   bf16 prefill of 4 × 2048 seeded tokens with attn_mode="pallas" over the
   mesh, each rank launching flash_attention (fa_wgmma<112>, 16 of 32
   heads) once (checked; the launches added to the kernels line), that
   call's local inputs (2, 16, 2048, 112) held to the plain version on
   every rank by phase 28's bf16 rule (rank 0's call also timed and
   reported there, its own row of the kernels line's shapes), its
   state in ``cache_specs``' placements (checked), and 4 decode steps fed
   the same seeded tokens, the logits' RMS distance from the one-device
   run of the same weights in f32 within 1.5× the one-device bf16 run's
   (or 5 % of their std: phase 18's rule over RMS distances from f32,
   since the sharded run rounds every row-split product's partial sums to
   bf16 and this random hybrid's bf16 logits lie tenths of their std from
   f32's);
21. the MoE family at full width: Moonlight-16B-A3B at 24 of its 48 layers
   (``MOE_SERVE_LAYERS``; ``configs/moonshot_v1_16b_a3b.py`` ``CONFIG``: 64 experts,
   top-6, bf16, parameters from ``model.init`` with seed 0), after the
   earlier phases' models are freed, served with ``attn_mode="pallas"``
   as phase 18 serves Qwen2-1.5B (the same traffic, ``make_run_wave`` and
   ``serve_loop``, a warm-up wave), ``flash_attention`` launched once a
   layer a wave; the plain path (``ref``) and ``chunked`` as they run, each
   path's (token, layer) routing flips against the plain path counted over
   the prefill's tokens and the decode steps fed the same tokens, each flip
   at a plain-path top-k margin p_(k) − p_(k+1) no larger than the two
   runs' two largest |Δp| of that token (checked), and the logits the
   flips move printed; then f64 attention, pallas and chunked with the
   routing pinned to the plain path's (each call takes the plain run's
   experts, places and kept choices, weighed by its own probabilities),
   held by phase 18's rule; the share of choices dropped per layer in
   prefill; the floors beside the times (a decode step reads every
   weight; a prefill wave's expert products compute E·C slots); then
   ``moe_block`` alone on layer 0's input (T = 8192): bf16 twice, the same
   bits, timed; f32 against f64, both on the card;
22. Mixtral-8x7B's full widths at 8 of its 32 layers (all 32 are 93.1 GB
   in bf16): one wave of 4 × 2048 prompts and 8 decode steps, as phase 21
   without ``chunked`` and without ``moe_block`` alone (``flash_attention``
   8 times, with a window of 4096);
23. the VLM family: Qwen2-VL-7B (``configs/qwen2_vl_7b.py`` ``CONFIG``, 28
   layers, M-RoPE sections (16, 24, 24), bf16, seed 0): ``model.prefill``
   on 4 × 2048 seeded stub embeddings with three position streams (a
   32 × 32 patch image, t = 0, h = row, w = col, then text continuing from
   the grid's largest position + 1), then 32 greedy decode steps from that
   cache (JAX's 1-D RoPE decode); pallas (``flash_attention`` 28 times,
   counted), the plain path, f64 attention and chunked, held by phase
   18's rule; then ``serve_loop`` through ``make_run_wave``'s vlm branch,
   which decodes from an empty cache with a zero token and no prefill, as
   JAX's launcher does: every request the same tokens;
24. the hybrid family: Zamba2-7B (``configs/zamba2_7b.py`` ``CONFIG`` at 39
   of its 81 Mamba2 layers, the shared attention + MLP at 7 points with
   d_head 112, bf16, parameters from ``model.init`` with seed 0, drawn layer
   by layer): ``model.prefill`` on 4 × 2048 numpy-seeded tokens, then 32
   greedy decode steps from that state; pallas (``flash_attention`` 7 times at
   (4, 32, 2048, 112), counted), the plain path, f64 attention and
   chunked, held by phase 18's rule; the D = 112 call's ms and TFLOP/s
   beside the same shape at D = 128; ``ssd_chunked`` alone at a layer's
   shapes (4, 2048, 112, 64, N 64, chunk 64), f32 against f64 on the card
   (‖Δ‖ ≤ 1e-5·‖y‖), timed beside its floor; the floors of prefill (2·N·
   tokens at 989 TFLOP/s and the SSD's f32 einsums at 67) and decode (the
   weights and the SSM and KV state at 3.35 TB/s); then ``serve_loop``
   through ``make_run_wave``'s hybrid branch (an empty state, no prefill:
   every request the same tokens);
25. the RWKV family: RWKV6-1.6B (``configs/rwkv6_1_6b.py`` ``CONFIG``, 24
   layers, bf16, seed 0): ``model.prefill`` on 4 × 2048 tokens, then 32
   decode steps (no kernel: RWKV has no attention); the same weights in
   f32 and f64 on the card, the f32 logits within 1e-4 of the f64 logits'
   largest magnitude and the bf16 logits' RMS distance within 0.15 of
   their std (over the steps fed the same tokens); in f32, decode after a
   prefill of S − 1 tokens against the prefill of S (2e-3); the time
   scan's host cost (prefill µs per (position, layer)); then ``serve_loop``
   through the rwkv branch;
26. the enc-dec family: Whisper-base (``configs/whisper_base.py``
   ``CONFIG``, 6 + 6 layers, d_model 512, 8 heads of 64, bf16, seed 0)
   served with ``attn_mode="pallas"`` through ``serve_loop`` and
   ``make_run_wave``'s encdec branch after a warm-up: 32 requests in waves
   of 16, each wave 1500 stub frames drawn after the prompts from the
   launcher's generator, 64 greedy tokens, a cache of 448;
   ``flash_attention`` once per encoder layer per wave (12, counted),
   non-causal at (16, 8, 1500, 64), every launch against its plain version
   and one timed beside its bound and SDPA; the plain path, f64 attention
   and chunked, held by phase 18's rule (the decoder's cross-attention
   reads encoder frame 0 alone, ROADMAP Queue 3 item 30); then training:
   its widths at depth 2 + 2 in f32 on the card against f64 on the host
   (B = 1, S = 448 tokens and frames; the train phase's rule), and the
   full model in bf16 (AdamW lr 3e-3, remat, ``chunked``) for a warm-up
   and 4 steps at B = 16, S = 448, launching no kernel: losses finite and
   falling, step ms, tokens/s, peak GB, model-FLOPs share;
26b. the dense family's other configs at full width (``DENSE_SERVE``), as
   phase 18 serves Qwen2-1.5B but with 16 greedy tokens: StarCoder2-15B
   (group 12) and GLM4-9B (group 16) whole (40 layers each), 8 requests
   in waves of 4, Granite-34B (88, MQA: group 48; 67.32 GB) one
   wave of 4; ``flash_attention`` once per layer per
   wave, the first wave's first and last layer's calls recorded; the
   plain path, f64 attention (a batch row and at most 1 GB of f64 scores
   at a time) and chunked, held by phase 18's rule; ``init``'s temporaries
   within two f32 copies of its largest single draw (one layer of a
   stacked leaf), the phase's peak beside the card's memory, the prefill
   and decode floors beside the times;
27. training the MoE, VLM, hybrid and RWKV families and the three dense
   configs (``FAMILY_TRAIN``):
   Moonlight-16B-A3B, Qwen2-VL-7B (the launcher's stub embeddings and
   ``positions3``), Zamba2-7B (``chunked`` attention: the kernel has no
   backward), RWKV6-1.6B, StarCoder2-15B, GLM4-9B and Granite-34B, each
   at full width: 1 layer in f32 on the card (cut from 2 for the
   script's time) against f64 on the host (the train phase's rule, or up to
   WITNESS_FACTOR times the host's own f32 distance from f64 where that
   is larger) and in f64 on the card against the same (the train phase's
   rule); Moonlight at capacity factor 0.5 with its drops counted, the
   host's routing pinned to the card's; then in bf16 at the depth that
   fits 80 GB (2, 8, 24, 5, 8 and 5 layers; RWKV6 at 8 of 24 for the
   script's time) with the train phase's traffic (RWKV6 at S = 256: its
   scan's backward is the host's; Qwen2-VL-7B and the three dense configs
   at lr 3e-5: at 3e-3 the last loss ends above the first, and at 3e-5
   StarCoder2-15B's and Granite-34B's still climb at the second step),
   launching no kernel: losses finite and the last below the first, step
   ms, tokens/s,
   peak GB by part, the model-FLOPs
   share (the MoE's of its active parameters) and Moonlight's dropped
   share;
28. each kernel against its plain version on the inputs the paths gave it,
   both timed with CUDA events, with its bound (operations at the peak
   rate of the operands' type: bf16 on the tensor cores, else f32) and,
   for ``segsum`` and ``flash_attention``, the one PyTorch call
   (``index_add_``, ``scaled_dot_product_attention``) that computes the
   same function; for ``kmeans_step`` the read floor, ``torch.sum`` over
   each call's points (the card's achieved read rate, not a library call); each served attention call's distance from the
   tensor-core recipe beside its distance from the plain version; then one
   served call of each head width (128, 112 from Zamba2-7B and 64 from
   Whisper-base) in one ``torch.profiler`` window, which must show the
   tensor-core kernel (``fa_wgmma<D>``) and not the CUDA-core one
   (``fa_main``); the MoE,
   VLM, hybrid, enc-dec and 26b's phases add the first and last layer's
   (attention point's) call of their counted run; per shape, the calls'
   mean wrapper, plain, SDPA and bound ms;
29. per-query latency (median over ``--reps`` after a warm-up, each run
   compiled anew: the plan cache's misses), sequential and with ``parallel=4``, lineitem rows/s, the k-means step time and
   points/s, and the serving numbers (prefill ms per wave, decode ms per
   step, tokens/s, request latency p50/p99 from the port's tracer); with
   ``--profile``, device time by kernel and busy share, one serving wave
   included.

Then the card's line, the ``kernels`` JSON line (the relational kernels'
launches count the TPC-H path's run, the stream phase's counted folds and
the spmd ranks' main runs; ``kmeans_step``'s the k-means path's and the
spmd ranks' steps; ``flash_attention``'s the served Qwen2-1.5B, Moonlight,
Mixtral, Qwen2-VL, Zamba2-7B, Whisper-base, StarCoder2-15B, GLM4-9B and
Granite-34B runs) and, last,
``{"ok": true, "device": ...}``.  Any failed check raises, so the exit code
is not 0 and no result line is printed; without a visible CUDA device the
script exits with code 2.

Tolerances.  Kernel against plain version: integers (keys, counts,
validity) exact; floats within rtol 1e-4 of the plain value, because the
kernels add float sums with atomics and per-block partials, in another
order than torch's reductions (each order has error of order
sqrt(n)·2^-24 on n ≈ 10^6 terms); ``fused_select_agg`` and the reg route
of ``grouped_select_agg`` add in a fixed order, so two runs give the same
bits.  Query against the numpy reference: integers exact, floats rtol
2e-4 (tests/test_tpch.py's tolerance: f32
accumulation against an f64 oracle).  Segment sums: a sum may also
differ by 1e-5 of the sum of |x| over its segment, since a sum whose terms
cancel has a rounding error that scales with Σ|x| and not with the result.
k-means steps go by the tie-margin rule of ``repro_torch.kmeans`` (counts
add up to n and sums to Σx whatever the ties; each count and sum may move
by what the points within a few f32 roundings of a tie carry): steps
against numpy f64 at rtol 2e-4, kernel against plain version at rtol 1e-4.
Kernel calls on the ``parallel=4`` path are held against their plain
versions too, but timed and counted only on the sequential path.
``flash_attention`` against its plain version: bf16 outputs within two
bf16 roundings, |got − want| ≤ 2^-7·|want| + 1e-3·max|v| (both sum in f32
in different orders, then round); f32 outputs within rtol 1e-4, atol
1e-5.  The serving path against the plain path: the logits of the
prefill and of every decode step both paths were fed the same tokens
differ by at most the larger of 5 % of the prefill logits' standard
deviation and 1.5 times the noise floor, the same largest |Δ| between the
plain path and a run whose prefill attention is computed in f64 and
rounded once (exactly rounded).  In bf16 a rounding flip in one attention
output grows through 28 layers: that floor was 9.0 % of the std on the
H100, so 5 % alone holds no bf16 path, the exact one included.  Each
path's own distance from the exact run is printed beside it.  That logits
check is what holds decode: a step's greedy tokens can differ only where
the plain path's top-2 gap is under twice the logits' |Δ|, and random
weights make gaps of that order, so the tokens are checked only to be
their logits' argmax, and where each request's tokens first leave the
plain path's is printed with the plain path's top-2 gap there.  An MoE
path's routing can flip where a token's k-th and (k+1)-th router
probabilities sit within a rounding, and a flip moves that token by a
whole expert's output (and, under the capacity, what other tokens keep):
so flips are counted and each checked to sit at a margin the two runs'
|Δp| can cross, and the rule above is applied with the routing pinned to
the plain path's.  ``moe_block`` alone: bf16 twice the same bits; f32
against f64 on the card, routing flips only at f64 margins ≤ 1e-5 (the
f32 router moves a probability by about 1e-8), the agreeing tokens'
outputs within ‖Δ‖ ≤ 1e-5·‖y‖, aux rtol 1e-5.  The hybrid's paths go by
phase 18's rule; random Mamba layers amplify a rounding (the norm inside
the block divides rows of small RMS), so at 81 layers the noise floor is
itself several std and the rule has little power there: the per-call
kernel check (phase 28) holds the D = 112 kernel.  ``ssd_chunked`` alone:
f32 against f64 within ‖Δ‖ ≤ 1e-5·‖y‖ (f32 rounding of 64-term chunk
sums).  RWKV6 against f64 on the card: f32 within 1e-4 of the largest
f64 logit; bf16 by the RMS of the difference, at most 0.15 of the
logits' std (bf16 rounds every product and the residual stream to 8 bits
through 24 layers; ``tests/test_torch_rwkv.py`` holds the same bound at
24 layers on the CPU).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

KERNEL_RTOL = 1e-4
QUERY_RTOL = 2e-4
STEP_RTOL = 2e-4
#: H100 SXM data-sheet peaks: HBM bytes/s, f32 (non-tensor-core) op/s and
#: dense bf16 tensor-core op/s; a call's operations are bounded at the rate
#: of its operands' type (``ops_peak``)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16_TC = 989e12
#: flash_attention against its plain version (see the docstring)
ATTN_F32_RTOL, ATTN_F32_ATOL = 1e-4, 1e-5
ATTN_BF16_REL, ATTN_BF16_VMAX = 2.0 ** -7, 1e-3
#: the serving path against the plain path: logits within the larger of
#: LOGIT_STD_SHARE of their std and NOISE_FACTOR times the plain path's own
#: distance from exactly rounded attention
LOGIT_STD_SHARE, NOISE_FACTOR = 0.05, 1.5

#: the k-means path: examples/kmeans.py's d and k at 512 times its n
KMEANS_N, KMEANS_D, KMEANS_K, KMEANS_SEED, KMEANS_PARALLEL = 1 << 24, 8, 16, 0, 8
#: timed k-means steps after the warm-up
KMEANS_STEPS = 5
#: chunks of the TPC-H path with parallelism
PARALLEL = 4
#: the serving path: Qwen2-1.5B at full width and depth, its traffic
SERVE_ARCH = "qwen2-1.5b"
SERVE_REQUESTS, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, SERVE_CAP = 8, 4, 2048, 32, 2080
#: the training path: Qwen2-1.5B at full width and depth, bf16, AdamW at the
#: JAX launcher's lr, batches of tests/test_models_smoke.py's shape from
#: TokenPipeline(seed=0).batch_at(0); a warm-up step, then TRAIN_STEPS
TRAIN_B, TRAIN_S, TRAIN_LR, TRAIN_STEPS = 4, 2048, 3e-3, 4
#: the card against the host: full width at depth 2 in f32 on the card and
#: f64 on the host, one sequence of 512; loss rtol, gradient ‖Δ‖/‖g‖ (f32
#: rounding gives about 2e-6; a TF32 or bf16 product gives 1e-4 or more)
TRAIN_CHECK_DEPTH, TRAIN_CHECK_S = 2, 512
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL = 1e-5, 1e-5
#: the family checks also run the host in f32: the card's f32 distance from
#: the host's f64 may be up to this many times the host's own, leaf by leaf
#: (Zamba2-7B's random Mamba layers carry f32's rounding past
#: TRAIN_GRAD_REL at 2 layers, the card's more than the host's: PERF.md
#: §6, PR 27; _gap_report)
WITNESS_FACTOR = 4.0
#: on the card: remat off against on; microbatch 2 against 1 on B = 2
REMAT_RTOL, MICRO_LOSS_RTOL, MICRO_GRAD_REL = 1e-6, 1e-5, 1e-4
#: the launcher's bf16 resume against the uninterrupted run: loss rtol of
#: two bf16 roundings (the embedding's gradient is added by atomics)
RESUME_LOSS_RTOL = 2.0 ** -7
#: the MoE family: Moonlight-16B-A3B served at full width and
#: MOE_SERVE_LAYERS of its 48 layers with the serving path's traffic
#: (SERVE_*); Mixtral-8x7B at full width and
#: MIXTRAL_LAYERS of its 32 layers (all 32 are 93.1 GB in bf16), one wave
#: of SERVE_BATCH prompts and MIXTRAL_GEN decode steps
MOE_ARCH = "moonshot-v1-16b-a3b"
#: the three large dense configs' generated tokens: half the serving
#: traffic's, for the script's time limit (their decode is the host's,
#: 65-144 ms a step on an H100)
DENSE_GEN = 16
MIXTRAL_ARCH, MIXTRAL_LAYERS, MIXTRAL_GEN = "mixtral-8x7b", 8, 8
#: moe_block alone, f32 against f64 on the card: the routing may differ
#: only where the f64 top-k margin p_(k) − p_(k+1) is at most MOE_F64_MARGIN
#: (the f32 router's rounding moves a probability by about 1e-8); the
#: agreeing tokens' outputs within ‖Δ‖ ≤ MOE_F32_REL·‖y‖, aux within
#: MOE_F32_REL
MOE_F64_MARGIN, MOE_F32_REL = 1e-5, 1e-5
#: the VLM family: Qwen2-VL-7B at full width and depth, SERVE_BATCH ×
#: SERVE_PROMPT stub embeddings, a VLM_GRID × VLM_GRID image then text,
#: VLM_GEN decode steps
VLM_ARCH, VLM_GRID, VLM_GEN = "qwen2-vl-7b", 32, 32
#: the hybrid family: Zamba2-7B at full width and ZAMBA_SERVE_LAYERS of its
#: 81 Mamba2 layers (the shared attention at 7 of its 14 points, d_head 112;
#: cut for the script's time, as MOE_SERVE_LAYERS), SERVE_BATCH ×
#: SERVE_PROMPT tokens, ZAMBA_GEN decode steps; ssd_chunked alone, f32
#: against f64 on the card, within ‖Δ‖ ≤ SSD_REL·‖y‖ (f32 rounding of a
#: 64-term chunk sum gives about 1e-6)
ZAMBA_ARCH, ZAMBA_SERVE_LAYERS, ZAMBA_GEN, SSD_REL = "zamba2-7b", 39, 32, 1e-5
#: the RWKV family: RWKV6-1.6B at full width and depth, SERVE_BATCH ×
#: RWKV_PROMPT tokens, RWKV_GEN decode steps; against the same weights in
#: f64 on the card, over the steps fed the same tokens: the f32 logits
#: within RWKV_F32_REL of the f64 logits' largest magnitude (f32 rounding
#: through 24 layers and a 2048-step scan), the bf16 ones' RMS distance
#: within RWKV_BF16_RMS of their std (bf16 rounds every product and the
#: residual stream to 8 bits; tests/test_torch_rwkv.py holds 24 layers of
#: random weights on the CPU to the same share)
RWKV_ARCH, RWKV_PROMPT, RWKV_GEN = "rwkv6-1.6b", 2048, 32
RWKV_F32_REL, RWKV_BF16_RMS = 1e-4, 0.15
#: the enc-dec family: Whisper-base at full width and depth (6 + 6 layers),
#: WHISPER_REQUESTS requests in waves of WHISPER_BATCH, each encoding
#: WHISPER_FRAMES stub frames (Whisper's 30-second window after its
#: stride-2 conv, arXiv:2212.04356), then WHISPER_GEN greedy tokens in a
#: cache of WHISPER_CAP (the released models' decoder context, n_text_ctx);
#: trained on WHISPER_TRAIN_B × WHISPER_CAP tokens and frames, a warm-up and
#: WHISPER_TRAIN_STEPS steps
WHISPER_ARCH = "whisper-base"
WHISPER_REQUESTS, WHISPER_BATCH, WHISPER_FRAMES, WHISPER_GEN, WHISPER_CAP = 32, 16, 1500, 64, 448
WHISPER_TRAIN_B, WHISPER_TRAIN_STEPS = 16, 4
#: the dense family's other three configs at full width through
#: flash_attention at D = 128 and groups 12, 16 and 48: StarCoder2-15B and
#: GLM4-9B whole (40 layers each) with the serving path's
#: requests (SERVE_*), Granite-34B whole (67.32 GB in bf16, the largest
#: config one card holds whole) one wave of SERVE_BATCH; DENSE_GEN tokens
#: each
DENSE_SERVE = {"starcoder2-15b": {}, "glm4-9b": {}, "granite-34b": {"requests_n": SERVE_BATCH}}
#: Moonlight-16B-A3B's served depth: cut from 48 for the script's time
#: beside the sharded hybrid phase, on a card whose host builds and runs
#: slower (PERF.md §6)
MOE_SERVE_LAYERS = 24
#: exact_attention's f64 scores per slice: at most this many bytes
EXACT_SLICE_BYTES = 1 << 30
#: the sharded train step: Qwen2-1.5B's full widths at SHARDED_DEPTH of its
#: 28 layers over a (data 2, model 2) mesh of SHARDED_RANKS gloo ranks on
#: the card, TRAIN_B × TRAIN_S tokens in SHARDED_MICRO microbatches (so the
#: f32 accumulator is placed by tree_grad_specs), a warm-up and
#: SHARDED_STEPS steps in f32, then in bf16.  The depth is cut because gloo
#: copies every collective through the host at about 1 GB/s (the spmd phase) and an
#: f32 step moves about 2.2 GB per rank at 4 layers (the dry-run's count); 2
#: layers keep the whole script within its time limit beside the MoE step.
#: The f32 step against the one-device step: loss TRAIN_LOSS_RTOL, each
#: gradient leaf TRAIN_GRAD_REL; step 1's updated parameters by
#: ‖Δ‖ ≤ SHARDED_UPD_RTOL·‖u‖ + SHARDED_UPD_ATOL·lr·√n per leaf, u the
#: one-device update (AdamW sends g/(|g| + 1e-8): a gradient element near
#: 1e-8, f32 noise of either sum order, moves its update by up to lr;
#: tests/test_torch_train.py's rule)
SHARDED_DEPTH, SHARDED_RANKS, SHARDED_MESH, SHARDED_MICRO, SHARDED_STEPS = 2, 4, (2, 2), 2, 3
SHARDED_UPD_RTOL, SHARDED_UPD_ATOL = 2e-3, 1e-2
SHARDED_JOIN_S = 900
#: the sharded MoE step: Moonlight-16B-A3B's full widths at SHARDED_MOE_DEPTH
#: of its 48 layers (the four ranks share the card's 80 GB: rank 0 also
#: holds the one-device f32 step and its AdamW state) on the same mesh,
#: B = TRAIN_B, S = TRAIN_S, microbatch SHARDED_MICRO: the f32 step against
#: the one-device step, then SHARDED_MOE_STEPS timed f32 steps
SHARDED_MOE_DEPTH, SHARDED_MOE_STEPS = 1, 2
#: the sharded hybrid: Zamba2-7B's full widths at SHARDED_HYBRID_DEPTH of its
#: 81 layers (the shared block at layer 0) on the same mesh, the Mamba2 mixer
#: per rank (sharding.per_rank_mamba: 56 of 112 SSM heads a rank).  The f32
#: step against the one-device step on rank 0, B = TRAIN_B, S = TRAIN_S,
#: microbatch SHARDED_MICRO: the loss rtol TRAIN_LOSS_RTOL, each gradient
#: leaf ‖Δ‖/‖g‖ within TRAIN_GRAD_REL or WITNESS_FACTOR × the one-device f32
#: step's own distance from its f64 step on the card (the random Mamba
#: layers carry f32's rounding past TRAIN_GRAD_REL: WITNESS_FACTOR's note);
#: then a warm-up and SHARDED_HYBRID_STEPS timed bf16 AdamW steps; then the
#: bf16 prefill of TRAIN_B × TRAIN_S numpy-seeded tokens with
#: attn_mode="pallas" over the mesh (the shared attention per rank:
#: flash_attention at 16 of 32 heads a rank, once a prefill) and
#: SHARDED_DECODE_STEPS decode steps fed the same seeded tokens: the logits'
#: RMS distance from the one-device run of the same weights in f32 within the
#: larger of LOGIT_STD_SHARE of their std and NOISE_FACTOR × the one-device
#: bf16 run's own (phase 18's rule over RMS distances from f32: this random
#: hybrid's bf16 logits lie tenths of their std from f32's, and the sharded
#: run rounds every row-split product's partial sums to bf16 before they
#: are added over the ranks, so two bf16 runs differ by about twice that)
SHARDED_HYBRID_DEPTH, SHARDED_HYBRID_STEPS, SHARDED_DECODE_STEPS = 2, 2, 4
#: training the MoE, VLM, hybrid and RWKV families and the dense configs
#: other than Qwen2-1.5B on the card, per arch:
#: (the card-vs-host check's depth and S at B = 1, the bf16 cell's depth,
#: S, timed steps, AdamW's lr and the reason for its cuts).  The cell's depth is what
#: fits 80 GB at about 22 bytes a parameter (bf16 parameter and gradient,
#: f32 moments, and AdamW's new state beside the old) beside the
#: activations of B = TRAIN_B × S tokens; the check's what the host's f64
#: autograd does within seconds
FAMILY_TRAIN = {
    "moonshot-v1-16b-a3b": (1, 256, 2, TRAIN_S, 3, TRAIN_LR,
                            "27.72 B parameters are about 610 GB at 22 B each; 3 of 48 layers "
                            "(2.05 B) peaked at 75.59 GB in the AdamW update alone on an H100, "
                            "so 2 (1.48 B) beside the earlier phases' tables"),
    # lr 3e-5: at 3e-3, 1e-3 and 1e-4 its first AdamW step (every weight
    # moved by about lr, at d = 3584) drops the loss far and the next steps
    # climb (3e-3: 12.56, 7.22, 28.58, 15.78 on an H100 80GB HBM3 at 700 W);
    # at 3e-5 it falls at every step (PERF.md §6, PR 27)
    "qwen2-vl-7b": (1, 256, 8, TRAIN_S, 3, 3e-5,
                    "7.07 B parameters are about 156 GB; 8 of 28 layers (2.41 B) fit"),
    "zamba2-7b": (1, 256, 24, TRAIN_S, 3, TRAIN_LR,
                  "6.64 B parameters are about 146 GB; 24 of 81 layers (4 shared-attention "
                  "points, 2.19 B) fit"),
    "rwkv6-1.6b": (1, 256, 8, 256, 2, TRAIN_LR,
                   "8 of 24 layers (0.57 B) and S cut to 256: the time scan's backward is an "
                   "S-step autograd chain a layer at the host's launch rate, 58.0 s a step at "
                   "S = 2048 and 14.6-16.1 s at 512 on an H100, 9.0 s at 256 and 24 layers, "
                   "past the script's time"),
    # lr 3e-5 for the three, as Qwen2-VL-7B: at 3e-3 StarCoder2-15B's first
    # AdamW step (every weight moved by about lr, at d = 6144) drops the
    # loss far and the next climbs past the first (12.47, 4.90, 20.18 on an
    # H100 80GB HBM3 at 700 W).  At 3e-5 the second step still climbs for
    # StarCoder2-15B (12.47, 2.33, 8.22) and Granite-34B (11.89, 3.09,
    # 5.62), and only ends below the first; GLM4-9B falls at every step
    # (PERF.md §6)
    "starcoder2-15b": (1, 256, 5, TRAIN_S, 2, 3e-5,
                       "15.65 B parameters are about 344 GB at 22 B each; 5 of 40 layers "
                       "(2.22 B) fit"),
    "glm4-9b": (1, 256, 8, TRAIN_S, 2, 3e-5,
                "8.78 B parameters are about 193 GB; 8 of 40 layers (2.25 B) fit"),
    "granite-34b": (1, 256, 5, TRAIN_S, 2, 3e-5,
                    "33.66 B parameters are about 741 GB; 5 of 88 layers (2.20 B) fit"),
}
#: the MoE check's capacity factor: low enough that choices are dropped
FAMILY_MOE_CHECK_CF = 0.5

TPCH_KERNELS = ("fused_select_agg", "grouped_select_agg", "grouped_join_agg")
REPLACES = {
    "fused_select_agg": "src/repro/kernels/fused_select_agg.py:84",
    "grouped_select_agg": "src/repro/kernels/grouped_select_agg.py:110",
    "grouped_join_agg": "src/repro/kernels/grouped_join_agg.py:158",
    "kmeans_step": "src/repro/kernels/kmeans_step.py:59",
    "segsum": "src/repro/kernels/segsum.py:47",
    "flash_attention": "src/repro/kernels/flash_attention.py:100",
}
SOURCES = {k: f"src/repro_torch/kernels/csrc/{k}.cu" for k in REPLACES}
#: the kernels generated per query: their sources above are templates that
#: follow the query's row functions, which this module writes
GENERATED_BY = {k: "src/repro_torch/kernels/codegen.py"
                for k in ("fused_select_agg", "grouped_select_agg", "grouped_join_agg")}
#: which queries' plans launch which kernel
EXPECTED = {
    "fused_select_agg": ("q6", "q14", "q19"),
    "grouped_select_agg": ("q1", "q4"),
    "grouped_join_agg": ("q4", "q12"),
}
GROUP_KEYS = {"q1": ("l_returnflag", "l_linestatus"), "q4": ("o_orderpriority",),
              "q12": ("l_shipmode",), "revenue": ("l_orderkey",)}


def log(*a) -> None:
    print(*a, flush=True)


#: ``time.perf_counter()`` when ``main`` started
T_START = time.perf_counter()


def stamp(what: str) -> None:
    """Log the seconds since the script started and the generated kernels
    built so far, at the end of ``what``."""
    from repro_torch.kernels import build

    log(f"[{time.perf_counter() - T_START:.1f} s since the start] {what} done "
        f"({build.GEN_STATS['built']} generated kernels built)")


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def _errors(got, want):
    """(max abs error, max error relative to rtol·max(|want|, 1)) of two
    float arrays; equal values (infinities too) count as 0."""
    import numpy as np

    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    with np.errstate(invalid="ignore"):
        diff = np.where(same, 0.0, np.abs(g - w))
    scale = np.maximum(np.abs(np.where(np.isfinite(w), w, 0.0)), 1.0)
    if diff.size == 0:
        return 0.0, 0.0
    return float(diff.max()), float((diff / scale).max())


def compare_outputs(name: str, got, want) -> float:
    """Kernel output against the plain version's: ints exact, floats
    within KERNEL_RTOL.  Returns the max absolute float error."""
    import numpy as np
    import torch

    from repro_torch.relational.runtime import VecTable

    if isinstance(want, VecTable):
        pairs = [("valid", got.valid, want.valid)]
        pairs += [(k, got.cols[k], want.cols[k]) for k in want.cols]
    else:
        pairs = [(k, got[k], want[k]) for k in want]
    worst = 0.0
    for k, g, w in pairs:
        g, w = g.detach().cpu(), w.detach().cpu()
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}.{k}: {g.dtype}{tuple(g.shape)} vs "
                                 f"{w.dtype}{tuple(w.shape)}")
        if not w.is_floating_point():
            if not torch.equal(g, w):
                bad = int((g != w).sum())
                raise AssertionError(f"{name}.{k}: {bad} integer values differ")
            continue
        abs_err, rel = _errors(g.numpy(), w.numpy())
        if rel > KERNEL_RTOL or np.isnan(rel):
            raise AssertionError(f"{name}.{k}: error {abs_err} (relative {rel}) "
                                 f"over rtol {KERNEL_RTOL}")
        worst = max(worst, abs_err)
    return worst


def check_query(qname: str, got, want) -> None:
    import numpy as np

    keys = GROUP_KEYS.get(qname, ())
    if keys:
        def order(d):
            o = np.lexsort([np.asarray(d[k]) for k in reversed(keys)])
            return {k: np.asarray(v)[o] for k, v in d.items()}
        got, want = order(got), order(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if g.shape != w.shape:
            raise AssertionError(f"{qname}.{k}: shape {g.shape} vs {w.shape}")
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64),
                                          err_msg=f"{qname}.{k}")
        else:
            np.testing.assert_allclose(g.astype(np.float64), w, rtol=QUERY_RTOL,
                                       err_msg=f"{qname}.{k}")


def check_segsum(what: str, got, data, ids, k) -> float:
    """segsum kernel against its plain version: rtol 1e-4 plus SUM_ABS of
    the segment's Σ|x|."""
    from repro_torch.kernels import ref
    from repro_torch.kmeans import SUM_ABS

    want = ref.segsum(data, ids, k)
    scale = ref.segsum(data.abs(), ids, k)
    err = (got - want).abs()
    if got.shape != want.shape or got.dtype != want.dtype or not bool(
            (err <= KERNEL_RTOL * want.abs() + SUM_ABS * scale).all()):
        raise AssertionError(f"{what}: differs from its plain version by {float(err.max())}")
    return float(err.max())


def check_attention(what: str, got, want, v):
    """flash_attention against its plain version: bf16 within two bf16
    roundings plus 1e-3 of max|v|; f32 within rtol 1e-4, atol 1e-5.
    Returns (the max absolute error, the largest share of the bound)."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if want.dtype == torch.bfloat16:
        bound = ATTN_BF16_REL * w.abs() + ATTN_BF16_VMAX * float(v.float().abs().max())
    else:
        bound = ATTN_F32_RTOL * w.abs() + ATTN_F32_ATOL
    if not bool((err <= bound).all()):
        raise AssertionError(f"{what}: differs from its plain version by {float(err.max())}")
    return float(err.max()), float((err / bound).max())


def tiled_gap(got, args, kw) -> float:
    """A bf16 attention output's largest distance from the tensor-core
    kernel's recipe (``ref.flash_attention_tiled``) on the same inputs."""
    from repro_torch.kernels import ref

    return float((got.float() - ref.flash_attention_tiled(*args, **kw).float()).abs().max())


@contextlib.contextmanager
def recording(names, keep=None):
    """Record each call of the ``ops`` wrappers ``names`` as (name, args,
    kw), to replay them against the plain versions afterwards (the emitters
    look the wrappers up on the module); with ``keep``, only the calls
    whose index i (counted over all of them) has ``keep(i)``."""
    from repro_torch.kernels import ops

    captured = []
    originals = {k: getattr(ops, k) for k in names}
    seen = [0]

    def recorder(name):
        def call(*args, **kw):
            if keep is None or keep(seen[0]):
                captured.append((name, args, kw))
            seen[0] += 1
            return originals[name](*args, **kw)
        return call

    for k in names:
        setattr(ops, k, recorder(k))
    try:
        yield captured
    finally:
        for k, fn in originals.items():
            setattr(ops, k, fn)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device-clock ms of ``fn()`` over ``iters`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bytes(t) -> int:
    return t.numel() * t.element_size()


def work(name: str, args: tuple, kw: dict):
    """(bytes, operations) the call's function needs on this data.  k-means:
    the points and centroids read once, sums and counts written once, and
    n·k·(2d+3) f32 operations; segsum: rows and ids read once, the sums
    written once, an add per element.  The relational kernels: every
    column the predicate reads and the validity over all rows; columns
    read only by the aggregated values or keys, over the rows that pass;
    the build side of a join once; the result once.  Operations: the
    program's instructions per row evaluated (the cost of a VM step, where
    the kernel interprets it, is not counted)."""
    from repro_torch.kernels import exprcode
    from repro_torch.kernels.ops import _value_aggs
    from repro_torch.relational import runtime as rt

    if name == "kmeans_step":  # points and centroids in, sums and counts out
        x, c = args
        (n, d), k = x.shape, c.shape[0]
        return (n * d + 2 * k * d + k) * 4, n * k * (2 * d + 3)
    if name == "segsum":  # rows and ids in, the segment sums out
        data, ids, k = args
        n, d = data.shape
        return (n * (d + 1) + k * d) * 4, n * d
    if name == "flash_attention":  # q, k, v in, o out; two products per unmasked pair
        q, k, v = args
        b, hq, s, d = q.shape
        return _bytes(q) * 2 + _bytes(k) + _bytes(v), 4 * b * hq * d * attention_pairs(s, kw)
    if name == "grouped_join_agg":
        table, right = args
        pred, aggs = kw["pred"], kw["aggs"]
        keys = kw["keys"]
    else:
        table, pred, *rest = args
        aggs = rest[0] if name == "fused_select_agg" else rest[1]
        keys = () if name == "fused_select_agg" else rest[0]
        right = None
    vaggs = _value_aggs(aggs)
    pred_fields = set(pred.fields()) if pred is not None else set()
    value_fields = {f for a in vaggs for f in a.expr.fields()} | set(keys)
    passing = rt.mask_select(table, pred).valid if pred is not None else table.valid
    n_pass = int(passing.sum())
    cap = table.capacity
    nbytes = _bytes(table.valid) + sum(_bytes(table.cols[f]) for f in pred_fields)
    left_rest = [f for f in value_fields - pred_fields if f in table.cols]
    if right is not None:
        left_rest = sorted(set(left_rest) | (set(kw["left_on"]) - pred_fields))
        need = (value_fields & set(right.cols)) | set(kw["right_on"])
        nbytes += _bytes(right.valid) + sum(_bytes(right.cols[f]) for f in need)
    nbytes += sum(n_pass * table.cols[f].element_size() for f in left_rest)
    dtypes = {**({k: c.dtype for k, c in right.cols.items()} if right is not None else {}),
              **{k: c.dtype for k, c in table.cols.items()}}
    fields = pred_fields | value_fields
    prog = exprcode.compile_program(
        pred, [a.expr for a in vaggs],
        {f: exprcode.column_type(dtypes[f]) for f in fields}, {f: 0 for f in fields},
        max_stack=None)
    ops = cap * prog.n_pred + n_pass * (len(prog.code) - prog.n_pred)
    return nbytes, ops


def attention_pairs(s: int, kw: dict) -> int:
    """(query, key) pairs the mask keeps, out of s²."""
    from repro_torch.kernels import ref

    return int(ref.attention_mask(s, kw.get("causal", True), kw.get("window"), "cpu").sum())


def ops_peak(args: tuple) -> float:
    """The card's peak op/s for the call's operands: the bf16 tensor-core
    rate where its float tensors are all bf16, else f32 outside the tensor
    cores (tables, f32 tensors)."""
    import torch

    dtypes = {a.dtype for a in args if isinstance(a, torch.Tensor) and a.is_floating_point()}
    return PEAK_BF16_TC if dtypes == {torch.bfloat16} else PEAK_F32


def result_bytes(out) -> int:
    from repro_torch.relational.runtime import VecTable

    if isinstance(out, VecTable):
        return _bytes(out.valid) + sum(_bytes(c) for c in out.cols.values())
    return sum(_bytes(v) for v in out.values())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_card() -> str:
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    return smi


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    paths = build.build()
    for name in build.KERNELS:
        build.library(name)
    log(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc, one process per source; "
        f"{', '.join(build.KERNELS)}; fused_select_agg, grouped_select_agg and "
        "grouped_join_agg are generated per query at their first call)")
    for name, p in paths.items():
        entry = "?"
        for ln in p.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in ln:  # the mangled kernel the lines below describe
                entry = ln.split("'")[1] if "'" in ln else ln.strip()
            elif "registers" in ln or "spill" in ln:
                log(f"  ptxas {name} {entry}: {ln.strip()}")


def report_generated(when: str) -> None:
    """The generated kernels' libraries so far: built (and nvcc's seconds),
    reused from an earlier build, distinct queries in this process."""
    from repro_torch.kernels import build, ops

    g = build.GEN_STATS
    kernels = sum(len(q.kernels) for q in ops._QUERIES.values())
    per = g["nvcc_s"] / g["built"] if g["built"] else 0.0
    log(f"generated kernels {when}: {int(g['built'])} libraries built, {int(g['reused'])} "
        f"reused, {kernels} distinct query kernels; nvcc {g['nvcc_s']:.2f} s in all, "
        f"{per:.2f} s per library, slowest {g['nvcc_max_s']:.2f} s")
    log("generated: " + json.dumps({"when": when, **g, "queries": kernels}))


def routed(fn, *args, **kw):
    """fn(*args, **kw) and the generated kernel routes it launched."""
    from repro_torch.kernels import ops

    before = dict(ops.GEN_LAUNCHES)
    out = fn(*args, **kw)
    return out, [r for r in before for _ in range(ops.GEN_LAUNCHES[r] - before[r])]


def same_bits(name: str, a, b) -> None:
    """Two outputs of a kernel (dicts or VecTables) must be bit-identical."""
    import torch

    from repro_torch.relational.runtime import VecTable

    if isinstance(a, VecTable):
        pairs = [("valid", a.valid, b.valid)] + [(k, a.cols[k], b.cols[k]) for k in a.cols]
    else:
        pairs = [(k, a[k], b[k]) for k in a]
    for k, x, y in pairs:
        if not torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y):
            raise AssertionError(f"{name}.{k}: two runs give different bits")


#: grouped_select_agg's routes at their borders: with three values (1 + 3
#: accumulators a bucket), reg ends at 16 buckets and smem at 3072 (48 KB)
GSA_BORDERS = ((16, "gsa_reg"), (17, "gsa_smem"), (3072, "gsa_smem"), (3073, "gsa_global"))


def deep_predicate(depth: int = 24):
    """Or-ed comparisons nested deeper than the interpreter's stack of 16."""
    from repro_torch.core.expr import col

    e = col("x") > 1.9
    for k in range(depth):
        e = (col("k").eq(k % 7) & (col("a") < k - 12)) | e
    return e


def phase_edges() -> None:
    """Kernels against plain versions on small cases at the edges."""
    import numpy as np

    from repro_torch.convert import vectable_from_arrays
    from repro_torch.core.expr import AggSpec, col, const
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(1)
    n = 1003  # not a multiple of the block size
    cols = {
        "a": rng.integers(-50, 50, n).astype(np.int32),
        "x": rng.uniform(-2, 2, n).astype(np.float32),
        "d": np.round(rng.uniform(0, 0.1, n), 2).astype(np.float32),
        "k": rng.integers(0, 7, n).astype(np.int32),
        "fk": rng.integers(-3, 40, n).astype(np.int32),  # partly out of domain
        "flag": rng.random(n) < 0.5,
    }
    valid = rng.random(n) < 0.9
    t = vectable_from_arrays(cols, valid, "cuda")
    aggs = (AggSpec("sum", col("x") * (1.0 - col("d")), "s"),
            AggSpec("min", col("x"), "mn"), AggSpec("max", col("a") / 3, "mx"),
            AggSpec("count", const(1), "c"), AggSpec("sum", col("flag"), "sf"))
    preds = {
        "mixed": (col("d") <= 0.07) & (col("a") > -10.5) & ~col("flag"),
        "empty": col("a") > 1000,
    }
    aggs3 = (AggSpec("sum", col("x") * 2.0, "s"), AggSpec("min", col("a"), "mn"),
             AggSpec("max", col("x"), "mx"), AggSpec("count", const(1), "c"))
    deep = deep_predicate()
    gsa_args = {label: [] for label in preds}
    for label, pred in preds.items():
        for nb_keys, doms in ((("k",), ((0, 6),)), (("k", "a"), ((0, 6), (-50, 49))),
                              (("fk", "a"), ((0, 99), (-2000, 1999)))):
            nb = math.prod(hi - lo + 1 for lo, hi in doms)
            gsa_args[label].append((t, pred, nb_keys, aggs, min(nb, 64), doms, nb))
    border_args = [(t, col("a") > -20, ("fk",), aggs3, nb, ((-3, nb - 4),), nb)
                   for nb, _ in GSA_BORDERS]
    deep_args = (t, deep, ("k",), aggs3, 7, ((0, 6),), 7)
    right, join_kws = _edge_join_cases(t, preds, rng)
    # every kernel of the phase built at once (one nvcc each) before the
    # first launch
    t0 = time.perf_counter()
    n_built = build_at_once(
        [lambda pred=pred: ops.fused_select_agg(t, pred, aggs) for pred in preds.values()]
        + [lambda: ops.fused_select_agg(t, deep, aggs3)]
        + [lambda args=args: ops.grouped_select_agg(*args)
           for args in [a for v in gsa_args.values() for a in v] + border_args + [deep_args]]
        + [lambda kw=kw: ops.grouped_join_agg(t, right, **kw) for _, kw in join_kws])
    log(f"edge cases: {n_built} generated kernels built at once in "
        f"{time.perf_counter() - t0:.1f} s")
    checked = 0
    routes = {}
    for label, pred in preds.items():
        got = ops.fused_select_agg(t, pred, aggs)
        want = ref.fused_select_agg(t, pred, aggs)
        compare_outputs(f"fused_select_agg[{label}]", got, want)
        checked += 1
        if label == "empty" and not (float(got["mn"]) == float("inf")
                                     and float(got["mx"]) == float("-inf")):
            raise AssertionError("empty selection must give min=+inf, max=-inf")
        for args in gsa_args[label]:
            nb = args[-1]
            got, took = routed(ops.grouped_select_agg, *args)
            compare_outputs(f"grouped_select_agg[{label},nb={nb}]", got,
                            ref.grouped_select_agg(*args))
            routes[f"{label}, nb={nb}"] = took
            checked += 1
    # the routes at their borders, a predicate deeper than the interpreter's
    # stack, and the fixed-order kernels run twice
    for args, (nb, route) in zip(border_args, GSA_BORDERS):
        got, took = routed(ops.grouped_select_agg, *args)
        if took != [route]:
            raise AssertionError(f"grouped_select_agg with {nb} buckets took {took}, not {route}")
        compare_outputs(f"grouped_select_agg[border nb={nb}]", got, ref.grouped_select_agg(*args))
        routes[f"border, nb={nb}"] = took
        checked += 1
    compare_outputs("fused_select_agg[deep predicate]", ops.fused_select_agg(t, deep, aggs3),
                    ref.fused_select_agg(t, deep, aggs3))
    got, took = routed(ops.grouped_select_agg, *deep_args)
    compare_outputs("grouped_select_agg[deep predicate]", got,
                    ref.grouped_select_agg(*deep_args))
    routes["deep predicate, nb=7"] = took
    checked += 2
    same_bits("fused_select_agg[mixed]", ops.fused_select_agg(t, preds["mixed"], aggs),
              ops.fused_select_agg(t, preds["mixed"], aggs))
    args = (t, preds["mixed"], ("k",), aggs, 7, ((0, 6),), 7)
    same_bits("grouped_select_agg[mixed, reg]", ops.grouped_select_agg(*args),
              ops.grouped_select_agg(*args))
    log(f"edge cases, grouped_select_agg routes: {json.dumps(routes)}")
    join_routes = {}
    for label, kw in join_kws:
        got, took = routed(ops.grouped_join_agg, t, right, **kw)
        compare_outputs(f"grouped_join_agg[{label},{'+'.join(kw['keys'])}]", got,
                        ref.grouped_join_agg(t, right, **kw))
        join_routes[f"{label}, nb={kw['num_buckets']}"] = took
        checked += 1
        if label == "mixed" and took == ["gja_reg"]:
            same_bits(f"grouped_join_agg[{label}, reg]", got,
                      ops.grouped_join_agg(t, right, **kw))
    want = {"gja_reg", "gja_smem", "gja_global"}
    if {r for took in join_routes.values() for r in took} != want:
        raise AssertionError(f"grouped_join_agg's edge cases took {join_routes}, not all of {want}")
    log(f"edge cases, grouped_join_agg routes: {json.dumps(join_routes)}")
    log(f"edge cases: {checked} kernel calls match their plain versions; fused_select_agg "
        "and the reg routes of grouped_select_agg and grouped_join_agg give the same bits "
        "twice")
    report_generated("after the edge cases")


class _Recorded(BaseException):
    """Raised by ``build_at_once``'s first pass in place of a generated
    kernel's build (not an ``Exception``: the wrappers' fault handling
    lets it by)."""


def build_at_once(calls) -> int:
    """Build the generated kernels that ``calls`` (thunks of the relational
    wrappers) would build at their first launch, one nvcc each and all at
    once, so that the calls then find them built: a first pass runs each
    call up to its kernel's build and notes the kernel's text instead, then
    each distinct text not built yet is built in a thread of its own.  A
    call whose kernel is already loaded runs whole in the first pass.
    Returns how many kernels it built."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build

    real, texts = build.build_generated, {}

    def note(family, text):
        path = build.generated_path(family, text)
        if not path.exists():
            texts.setdefault(path, (family, text))
        raise _Recorded

    build.build_generated = note
    try:
        for call in calls:
            try:
                call()
            except _Recorded:
                pass
    finally:
        build.build_generated = real
    if texts:
        with ThreadPoolExecutor(len(texts)) as pool:
            list(pool.map(lambda ft: real(*ft), texts.values()))
    return len(texts)


def prebuild_plans(frames) -> int:
    """``build_at_once`` over whole plans: each frame collected on the card
    (no plan cache) under the strategies the later phases collect the six
    queries under stops at its first generated kernel not yet built, so
    passes repeat, each building what it noted at once, until a pass notes
    none; a plan left out builds its kernels at first use.  Returns how
    many it built."""
    variants = ({}, {"parallel": PARALLEL}, {"strategy": SORTED},
                {"parallel": PARALLEL, "strategy": SORTED},
                {"strategy": {"fuse": "unfused"}}, {"strategy": {"encode": "dict"}})
    calls = [lambda f=f, kw=kw: f.collect(device="cuda", cache=False, **kw)
             for f in frames.values() for kw in variants]
    total = n = build_at_once(calls)
    while n:
        n = build_at_once(calls)
        total += n
    return total


def _edge_join_cases(t, preds, rng):
    """The edge phase's grouped_join_agg cases: the build side (duplicate
    keys, first occurrence wins; keys outside the probe's domain; a group
    key and a value on the build side) and [(label, keywords)].  With three
    values, 7 groups take the reg route, 21 the smem one, and 400,000 (past
    the 48 KB of shared accumulators) the global one."""
    import numpy as np

    from repro_torch.convert import vectable_from_arrays
    from repro_torch.core.expr import AggSpec, col, const

    m = 64
    rkeys = rng.integers(0, 30, m).astype(np.int32)
    right = vectable_from_arrays(
        {"rk": rkeys, "g": rng.integers(0, 3, m).astype(np.int32),
         "w": rng.uniform(0, 5, m).astype(np.float32)},
        rng.random(m) < 0.9, "cuda")
    jaggs = (AggSpec("count", const(1), "c"), AggSpec("sum", col("w") * col("x"), "s"),
             AggSpec("max", col("w"), "mx"), AggSpec("min", col("a"), "mn"))
    cases = []
    for label, pred in (("mixed", preds["mixed"]), ("none", None), ("empty", preds["empty"])):
        for keys, doms in ((("k",), ((0, 6),)), (("g", "k"), ((0, 2), (0, 6))),
                           (("fk", "a"), ((0, 99), (-2000, 1999)))):
            nb = math.prod(hi - lo + 1 for lo, hi in doms)
            cases.append((label, dict(left_on=("fk",), right_on=("rk",),
                                      join_key_domains=((0, 29),), join_num_buckets=30,
                                      keys=keys, aggs=jaggs, max_groups=nb, key_domains=doms,
                                      num_buckets=nb, pred=pred)))
    return right, cases


def phase_edges_la(pool) -> None:
    """kmeans_step and segsum against their plain versions at the edges."""
    import numpy as np
    import torch

    from repro_torch.convert import tensors_from_arrays
    from repro_torch.kernels import ops, ref
    from repro_torch.kmeans import check_step, near_ties, reference_step

    def clusters(n, d, k, seed):
        rng = np.random.default_rng(seed)
        centres = rng.normal(0, 5, (k, d))
        x = centres[rng.integers(0, k, n)] + rng.normal(0, 1, (n, d))
        return x.astype(np.float32), rng.normal(0, 5, (k, d)).astype(np.float32)

    # label: (points, centroids, (rows, floats) before the view's start)
    cases = {
        "ragged n": clusters(1003, 8, 16, 1),       # n not a multiple of any block
        "n < one tile": clusters(100, 8, 16, 9),
        "n not a multiple of 8 or 16": clusters(1001, 8, 16, 10),
        "k=1": clusters(1000, 8, 1, 2),
        "d=3": clusters(999, 3, 7, 3),
        "k=64 d=8 (top of the tensor-core range)": clusters(6000, 8, 64, 11),
        "k=32 d=16 (top of the tensor-core range)": clusters(6000, 16, 32, 12),
        "k=16 d=32 (top of the tensor-core range)": clusters(6000, 32, 16, 13),
        "k=65 d=8 (past the tensor-core range)": clusters(3000, 8, 65, 14),
        "d=128": clusters(2000, 128, 8, 4),         # the widest point the kernel takes
        "k*d past 48 KB": clusters(5000, 64, 256, 5),    # dynamic shared memory
        "k*d past opt-in": clusters(3000, 64, 512, 6),   # global accumulators
    }
    cases["d=1 at adversarial near-ties"] = near_ties(16, 256, 24, 0)
    cases = {label: (x, c, (0, 0)) for label, (x, c) in cases.items()}
    # chunk views whose start is not 16-byte aligned, as a Split makes them
    cases["view 4 bytes into a 16-byte granule"] = (*clusters(4099, 8, 16, 15), (0, 1))
    cases["view of d=3 rows from row 5 (60 bytes in)"] = (*clusters(3001, 3, 7, 16), (5, 0))
    x, c = clusters(4099, 8, 6, 7)
    c[4] = c[2]   # an exact copy: its points go to index 2, index 4 counts 0
    c[5] = 1e4    # far from every point: an empty cluster, zero sums
    cases["duplicate and far centroids"] = (x, c, (0, 0))
    routes = {}
    for label, (x, c, (rows, floats)) in cases.items():
        n, d = x.shape
        flat = np.zeros((rows + n + 1) * d + floats, np.float32)
        at = rows * d + floats
        flat[at:at + n * d] = x.ravel()
        xt = torch.from_numpy(flat).to("cuda")[at:at + n * d].view(n, d)
        ct = torch.from_numpy(c).to("cuda")
        before = dict(ops.KMEANS_LAUNCHES)
        got = ops.kmeans_step(xt, ct)
        routes[label] = [r for r in before if ops.KMEANS_LAUNCHES[r] != before[r]][0]
        check_step(f"kmeans_step[{label}]", got, ref.kmeans_step(xt, ct),
                   reference_step(x, c, pool.map), KERNEL_RTOL)
        if label.startswith("duplicate"):
            sums, counts = got
            if not (counts[4] == 0 and counts[2] > 0 and counts[5] == 0
                    and bool((sums[4] == 0).all()) and bool((sums[5] == 0).all())):
                raise AssertionError(f"kmeans_step: copies and empty clusters: {counts.tolist()}")
    before = dict(ops.KMEANS_LAUNCHES)
    sums, counts = ops.kmeans_step(torch.zeros((0, 8), device="cuda"),
                                   torch.ones((16, 8), device="cuda"))
    routes["n=0"] = [r for r in before if ops.KMEANS_LAUNCHES[r] != before[r]][0]
    if bool(sums.any()) or bool(counts.any()):
        raise AssertionError("kmeans_step: no points must give zero sums and counts")
    log(f"kmeans_step edge cases' routes: {json.dumps(routes)}")
    rng = np.random.default_rng(8)
    # label: (n, d, K, (rows, floats) before the view's start)
    seg_cases = {"ragged n": (1003, 8, 16, (0, 0)), "d=1": (777, 1, 3, (0, 0)),
                 "d=1 view 4 bytes into a 16-byte granule": (777, 1, 3, (0, 1)),
                 "d=3 view from row 5 (60 bytes in)": (3001, 3, 7, (5, 0)),
                 "K=64 d=8 (top of the tensor-core range)": (4099, 8, 64, (0, 0)),
                 "K=65 d=8 (past the tensor-core range)": (3000, 8, 65, (0, 0)),
                 "K*d past 48 KB": (5000, 64, 256, (0, 0)),
                 "K*d past opt-in": (3000, 64, 1024, (0, 0))}
    seg_routes = {}
    for label, (n, d, k, (rows, floats)) in seg_cases.items():
        data = rng.normal(size=(n, d)).astype(np.float32)
        ids = rng.integers(-2, k + 2, n).astype(np.int32)  # some out of range
        ids[:5] = k - 1
        ids[ids == 1] = 0  # segment 1 stays empty
        flat = np.zeros((rows + n + 1) * d + floats, np.float32)
        at = rows * d + floats
        flat[at:at + n * d] = data.ravel()
        dt = torch.from_numpy(flat).to("cuda")[at:at + n * d].view(n, d)
        it = torch.from_numpy(ids).to("cuda")
        before = dict(ops.SEGSUM_LAUNCHES)
        got = ops.segsum(dt, it, k)
        seg_routes[label] = [r for r in before if ops.SEGSUM_LAUNCHES[r] != before[r]][0]
        check_segsum(f"segsum[{label}]", got, dt, it, k)
        if not bool((got[1] == 0).all()):
            raise AssertionError("segsum: an empty segment is not zero")
    torch.cuda.synchronize()
    log(f"segsum edge cases' routes: {json.dumps(seg_routes)}")
    log(f"edge cases: {len(cases) + 1} kmeans_step and {len(seg_cases)} segsum calls match "
        "their plain versions")


def phase_main_path(sf: float):
    """Generate TPC-H, run the six queries once through Frame.collect on
    the card with the launch counts set to 0 just before, and hold each
    result against the numpy reference."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.relational import tpch

    t0 = time.perf_counter()
    tables = tpch.generate(sf=sf, seed=0)
    ctx = tpch.make_context(tables)
    ctx.statistics()
    srcs = ctx.sources("cuda")
    torch.cuda.synchronize()
    sizes = {k: len(next(iter(v.values()))) for k, v in tables.items()}
    dev_bytes = sum(c.numel() * c.element_size() + t.valid.numel()
                    for t in srcs.values() for c in t.cols.values())
    log(f"tpch sf={sf} seed=0: {sizes}; {dev_bytes / 1e6:.1f} MB of columns on the card; "
        f"set-up {time.perf_counter() - t0:.1f} s")
    frames = {q: f(ctx) for q, f in tpch.QUERIES.items()}
    t0 = time.perf_counter()
    n_built = prebuild_plans(frames)
    log(f"the plans' generated kernels: {n_built} built at once, one nvcc each, in "
        f"{time.perf_counter() - t0:.1f} s")

    per_query, routes = {}, {}
    results = {}
    with recording(TPCH_KERNELS) as captured:
        ops.reset_launches()
        for q, frame in frames.items():
            before = dict(ops.LAUNCHES)
            results[q], routes[q] = routed(frame.collect, device="cuda")
            per_query[q] = {k: ops.LAUNCHES[k] - before[k] for k in before}
        launches = dict(ops.LAUNCHES)
        gen_launches = dict(ops.GEN_LAUNCHES)

    for q, got in results.items():
        check_query(q, got, tpch.REFERENCES[q](tables))
    log(f"TPC-H path: six queries match the numpy references; launches {launches}")
    for kname, queries in EXPECTED.items():
        for q in queries:
            if per_query[q][kname] < 1:
                raise AssertionError(f"{q} did not launch {kname}: {per_query[q]}")
    check_routes("TPC-H path", launches, gen_launches, routes)
    report_generated("after the TPC-H path")
    same_bits_on_path(captured)
    phase_tpch_route(frames)
    gsa_split(captured)
    gja_split(captured)
    return tables, ctx, frames, launches, captured


def check_routes(what: str, launches, gen_launches, routes) -> None:
    """Every relational kernel call of a TPC-H run launched a generated
    kernel; Q1 took grouped_select_agg's reg route and Q4 an atomic one,
    and Q4's and Q12's joins took grouped_join_agg's reg route.  Prints
    each query's routes."""
    gsa = sum(gen_launches[r] for r in ("gsa_reg", "gsa_smem", "gsa_global"))
    gja = sum(gen_launches[r] for r in ("gja_reg", "gja_smem", "gja_global"))
    if gen_launches["fsa_gen"] != launches["fused_select_agg"] or gsa != launches[
            "grouped_select_agg"] or gja != launches["grouped_join_agg"]:
        raise AssertionError(f"{what}: generated routes {gen_launches} for launches {launches}")
    joins = [r for q in ("q4", "q12") for r in routes[q] if r.startswith("gja")]
    if "gsa_reg" not in routes["q1"] or any(
            r not in ("gsa_global", "gsa_smem") for r in routes["q4"] if r.startswith("gsa")
    ) or not joins or any(r != "gja_reg" for r in joins):
        raise AssertionError(f"{what}: Q1 took {routes['q1']}, Q4 {routes['q4']}, "
                             f"Q12 {routes['q12']}")
    log(f"{what}, generated kernel routes per query: {json.dumps(routes)}; in all "
        f"{json.dumps(gen_launches)}")


def same_bits_on_path(captured) -> None:
    """The path's fused_select_agg calls and its grouped_select_agg and
    grouped_join_agg calls on the reg route, run twice more: the same bits
    (replays, not counted)."""
    from repro_torch.kernels import ops

    n = 0
    for name, args, kw in captured:
        first, took = routed(getattr(ops, name), *args, **kw)
        if took[0] not in ("fsa_gen", "gsa_reg", "gja_reg"):
            continue
        same_bits(f"{name} on the path", first, getattr(ops, name)(*args, **kw))
        n += 1
    log(f"TPC-H path: its {n} fused_select_agg and reg-route grouped_select_agg and "
        "grouped_join_agg calls give the same bits when run again")


#: the generated kernels a TPC-H pass must run (fragments of their names:
#: fused_select_agg; grouped_select_agg's reg and atomic routes; the join's
#: build and its probe on the reg route)
TPCH_GENERATED = ("fsa_gen", "grp_reg<GsaRows>", "grp_atomic<GsaRows", "gja_gen_fill",
                  "gja_gen_build", "grp_reg<GjaRows>")
#: the prefixes of the relational kernels' names, the old expression
#: interpreter's among them (fsa_main, gsa_main, vm_init_accumulators, ...):
#: a kernel of a TPC-H pass that bears one must be a generated one
RELATIONAL_PREFIXES = ("fsa_", "gsa_", "gja_", "vm_")


def _kernel_name(event_key: str) -> str:
    """A profiler kernel's function name: its key without the return type
    and the arguments (``void grp_reg<GjaRows>(...)`` → ``grp_reg<GjaRows>``)."""
    return event_key.split("(")[0].split()[-1]


def phase_tpch_route(frames) -> None:
    """One pass over the six queries under torch.profiler (after a warm-up
    window): the generated kernels ran, and no kernel of the expression
    interpreter that the relational kernels used to run."""
    names = device_kernels(lambda: [f.collect(device="cuda") for f in frames.values()], reps=1)
    ours = [n for n in names if any(k in n for k in OUR_KERNELS)]
    missing = [k for k in TPCH_GENERATED if not any(k in n for n in names)]
    stale = [n for n in names if _kernel_name(n).startswith(RELATIONAL_PREFIXES)
             and not any(k in n for k in TPCH_GENERATED)]
    if missing or stale:
        raise AssertionError(f"profiled TPC-H pass: missing {missing}, interpreter kernels "
                             f"{stale}; ran {ours}")
    log(f"profiled TPC-H pass: this package's kernels {json.dumps(ours)} (every "
        f"{', '.join(RELATIONAL_PREFIXES)} kernel a generated one: none of the interpreter's)")


@contextlib.contextmanager
def _epilogue_inputs():
    """Records, during grouped_select_agg calls, the inputs of its
    epilogue's decode_bucket_keys and compact."""
    from repro_torch.relational import runtime as rt

    seen = {}
    orig_decode, orig_compact = rt.decode_bucket_keys, rt.compact

    def decode(*a, **kw):
        seen["decode"] = (a, kw)
        return orig_decode(*a, **kw)

    def compact(*a, **kw):
        seen["compact"] = (a, kw)
        return orig_compact(*a, **kw)

    rt.decode_bucket_keys, rt.compact = decode, compact
    try:
        yield seen
    finally:
        rt.decode_bucket_keys, rt.compact = orig_decode, orig_compact


def gsa_split(captured) -> None:
    """The grouped_select_agg wrapper's time on Q1's and Q4's path calls
    (CUDA events, mean of 10), beside its parts alone on the same inputs:
    the launch (checks, the generated kernel's ctypes call and the kernel),
    the epilogue's decode_bucket_keys and compact.  Measured only."""
    from repro_torch.kernels import ops
    from repro_torch.relational import runtime as rt

    rows = []
    for name, args, kw in captured:
        if name != "grouped_select_agg":
            continue
        table, pred, keys, aggs, _, doms, nb = args
        with _epilogue_inputs() as seen:
            ops.grouped_select_agg(*args, **kw)
        (da, dkw), (ca, ckw) = seen["decode"], seen["compact"]
        row = {"buckets": nb, "rows": table.capacity,
               "wrapper_ms": cuda_ms(lambda: ops.grouped_select_agg(*args, **kw)),
               "launch_ms": cuda_ms(lambda: ops._grouped_select_launch(
                   table, pred, tuple(keys), tuple(aggs),
                   tuple((int(lo), int(hi)) for lo, hi in doms), nb)),
               "decode_bucket_keys_ms": cuda_ms(lambda: rt.decode_bucket_keys(*da, **dkw)),
               "compact_ms": cuda_ms(lambda: rt.compact(*ca, **ckw))}
        row["rest_ms"] = row["wrapper_ms"] - row["launch_ms"] - row[
            "decode_bucket_keys_ms"] - row["compact_ms"]
        rows.append(row)
    log("grouped_select_agg wrapper split (Q1, Q4): " + json.dumps(rows))


def gja_split(captured) -> None:
    """The grouped_join_agg wrapper's time on Q4's and Q12's path calls
    (CUDA events, mean of 10), beside its parts alone on the same inputs:
    the build launch and the probe launch (each a generated kernel's ctypes
    call and its kernels), the epilogue's decode_bucket_keys and compact;
    the rest is the checks, the query's lookup and the epilogue's sentinel
    mapping.  Measured only."""
    from repro_torch.kernels import ops
    from repro_torch.relational import runtime as rt

    rows = []
    for name, args, kw in captured:
        if name != "grouped_join_agg":
            continue
        left, right = args
        with _epilogue_inputs() as seen:
            ops.grouped_join_agg(*args, **kw)
        (da, dkw), (ca, ckw) = seen["decode"], seen["compact"]
        call = ops._join_call(left, right, kw["pred"], tuple(kw["left_on"]),
                              tuple(kw["right_on"]),
                              tuple((int(lo), int(hi)) for lo, hi in kw["join_key_domains"]),
                              int(kw["join_num_buckets"]), tuple(kw["keys"]), tuple(kw["aggs"]),
                              tuple((int(lo), int(hi)) for lo, hi in kw["key_domains"]),
                              int(kw["num_buckets"]))
        row = {"rows": left.capacity, "build_rows": right.capacity,
               "join_buckets": kw["join_num_buckets"], "buckets": kw["num_buckets"],
               "wrapper_ms": cuda_ms(lambda: ops.grouped_join_agg(*args, **kw)),
               "build_ms": cuda_ms(lambda: ops._join_build(call)),
               "probe_ms": cuda_ms(lambda: ops._join_probe(call)),
               "decode_bucket_keys_ms": cuda_ms(lambda: rt.decode_bucket_keys(*da, **dkw)),
               "compact_ms": cuda_ms(lambda: rt.compact(*ca, **ckw))}
        row["rest_ms"] = row["wrapper_ms"] - row["build_ms"] - row["probe_ms"] - row[
            "decode_bucket_keys_ms"] - row["compact_ms"]
        rows.append(row)
    log("grouped_join_agg wrapper split (Q4, Q12): " + json.dumps(rows))


def phase_kmeans(pool):
    """The k-means path at full width: FuseKMeansStep + Parallelize(8) on
    LocalBackend(use_kernels=True), a warm-up and KMEANS_STEPS steps with the
    launch counts set to 0 just before and read just after; each step held
    against a numpy f64 step from the same centroids; then the unfused
    program (plain torch) from the last step's centroids, its la.SegSum
    inputs recorded.  Returns (launches, the last step's kmeans_step calls,
    the SegSum inputs, step ms, a function that runs one more step)."""
    import numpy as np
    import torch

    from repro_torch.backends import emit
    from repro_torch.backends.local import LocalBackend
    from repro_torch.convert import tensors_from_arrays
    from repro_torch.kernels import ops
    from repro_torch.kmeans import check_step, make_data, program, reference_step

    n, d, k = KMEANS_N, KMEANS_D, KMEANS_K
    t0 = time.perf_counter()
    x, c0 = make_data(n, d, k, KMEANS_SEED)
    X, C = tensors_from_arrays(x, c0, device="cuda")
    torch.cuda.synchronize()
    log(f"k-means n={n} d={d} k={k} seed={KMEANS_SEED}: {X.numel() * 4 / 2 ** 20:.0f} MiB "
        f"of points on the card; set-up {time.perf_counter() - t0:.1f} s")
    fused = LocalBackend(use_kernels=True, device="cuda").compile(
        program(n, d, k, parallel=KMEANS_PARALLEL))

    steps, times = [], []
    with recording(("kmeans_step",)) as captured:
        ops.reset_launches()
        fused({}, X, C)  # warm-up
        for _ in range(KMEANS_STEPS):
            captured.clear()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sums, counts = fused({}, X, C)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            steps.append((C, sums, counts))
            C = sums / counts.clamp_min(1e-9)[:, None]
        launches = dict(ops.LAUNCHES)
        routes = dict(ops.KMEANS_LAUNCHES)
    expect = KMEANS_PARALLEL * (KMEANS_STEPS + 1)
    if launches["kmeans_step"] != expect:
        raise AssertionError(f"kmeans_step launched {launches['kmeans_step']} times, not {expect}")
    if routes != {"kms_tc": expect, "kms_main": 0}:
        raise AssertionError(f"the k-means path's kmeans_step calls took {routes}, not all "
                             "the tensor-core route")
    log(f"k-means path routes: {json.dumps(routes)} (all {expect} kmeans_step calls on the "
        "tensor cores, kms_tc)")

    for i, (c_in, sums, counts) in enumerate(steps):
        stats = reference_step(x, c_in.cpu().numpy(), pool.map)
        err = check_step(f"k-means step {i}", (sums, counts), (stats.sums, stats.counts),
                         stats, STEP_RTOL)
        dc = np.abs(counts.cpu().numpy() - stats.counts)
        log(f"  step {i}: matches numpy f64; {stats.n_amb} ambiguous points (at most "
            f"{int(stats.cand.max())} per centroid); counts differ by {int(dc.sum())} in all, "
            f"at most {int(dc.max())}; largest |sum difference| {err:.6g}")

    # the unfused program, from the last step's centroids
    seg_inputs = []
    segsum_emitter = emit._EMIT["la.SegSum"]

    def seg_recorder(ctx, ins, args):
        seg_inputs.append((args[0], args[1], int(ins.param("k"))))
        return segsum_emitter(ctx, ins, args)

    emit._EMIT["la.SegSum"] = seg_recorder
    try:
        unfused = LocalBackend(use_kernels=True, device="cuda").compile(
            program(n, d, k))
        c_in, sums, counts = steps[-1]
        got = unfused({}, X, c_in)
    finally:
        emit._EMIT["la.SegSum"] = segsum_emitter
    check_step("unfused program vs fused", got, (sums, counts), stats, KERNEL_RTOL)
    log(f"k-means path: {KMEANS_STEPS} steps match numpy f64, the unfused program matches the "
        f"fused one; launches {launches}")
    phase_kmeans_route(captured)
    return launches, list(captured), seg_inputs, times, lambda: fused({}, X, c_in)


def phase_kmeans_route(calls) -> None:
    """One k-means path call under torch.profiler (after a warm-up window):
    its device kernel must be the tensor-core kms_tc and not kms_main; then
    two more runs of it, which must give the same bits (the fixed-order
    sum)."""
    import torch

    from repro_torch.kernels import ops

    _, args, kw = calls[0]
    names = device_kernels(lambda: ops.kmeans_step(*args, **kw))
    if not any(KMS_TENSOR_CORE in n for n in names) or any(KMS_CUDA_CORE in n for n in names):
        raise AssertionError(f"a k-means path kmeans_step call ran {names}, not {KMS_TENSOR_CORE}")
    log(f"k-means path kmeans_step call (x {tuple(args[0].shape)}) ran on the card as: {names}")
    first, second = ops.kmeans_step(*args, **kw), ops.kmeans_step(*args, **kw)
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError("two runs of a k-means path kmeans_step call differ")
    log("k-means path kmeans_step call run twice: sums and counts bit-identical")


def phase_segsum(seg_inputs):
    """segsum on the unfused program's la.SegSum inputs, counted alone:
    every call on the tensor-core route (``seg_tc``); one of them under
    torch.profiler, which must show seg_tc and not seg_main's fix_seg_*
    kernels, then run twice more: the same bits."""
    import torch

    from repro_torch.kernels import ops

    ops.reset_launches()
    outs = [ops.segsum(*a) for a in seg_inputs]
    torch.cuda.synchronize()
    launches, routes = dict(ops.LAUNCHES), dict(ops.SEGSUM_LAUNCHES)
    if launches["segsum"] != len(seg_inputs):
        raise AssertionError(f"segsum launched {launches['segsum']} times")
    if routes != {"seg_tc": len(seg_inputs), "seg_main": 0}:
        raise AssertionError(f"the SegSum calls took {routes}, not all the tensor-core route")
    for i, (out, a) in enumerate(zip(outs, seg_inputs)):
        check_segsum(f"segsum#{i}", out, *a)
    log(f"segsum on the SegSum inputs of the unfused k-means program: matches its plain "
        f"version; launches {launches}; routes {json.dumps(routes)}")
    names = device_kernels(lambda: ops.segsum(*seg_inputs[0]))
    if not any("seg_tc" in n for n in names) or any(SEG_CUDA_CORE in n for n in names):
        raise AssertionError(f"a SegSum segsum call ran {names}, not seg_tc")
    log(f"SegSum segsum call (data {tuple(seg_inputs[0][0].shape)}) ran on the card as: {names}")
    if not torch.equal(ops.segsum(*seg_inputs[0]), ops.segsum(*seg_inputs[0])):
        raise AssertionError("two runs of a SegSum segsum call differ")
    log("SegSum segsum call run twice: sums bit-identical")
    return launches, [("segsum", a, {}) for a in seg_inputs]


#: the routes whose f32 sums reach their accumulators in no fixed order
#: (ROADMAP Queue 3 item 17), and their inputs: grouped rows (the
#: stream's revenue state and Q4 run 750,000 buckets), kmeans_step's
#: (n, d, k) on kms_main, segsum's (n, d, K) on seg_main, the segment sum's
#: rows (over 7 segments)
DETERMINISM_ROWS = 1 << 18
DETERMINISM_BUCKETS = {"gsa_smem": 1000, "gsa_global": 750_000, "gja_smem": 1000,
                       "gja_global": 750_000}
DETERMINISM_KMS = (1 << 16, 64, 256)
DETERMINISM_SEG = (1 << 18, 8, 100)


def _summands(kind: str, n: int, buckets: int, rng):
    """``ordered``: 1e8, v, −1e8, … (v normal × 10^U(−4, 8)) in four
    buckets, a sum whose bits depend on the order of its adds; ``random``:
    normal values over every bucket."""
    import numpy as np

    if kind == "random":
        return rng.normal(size=n).astype(np.float32), rng.integers(0, buckets, n)
    v = (rng.normal(size=n) * 10.0 ** rng.uniform(-4, 8, n)).astype(np.float32)
    m = 3 * (n // 3)
    v[:m] = np.where(np.arange(m) % 3 == 1, v[:m], np.tile(np.float32([1e8, 0, -1e8]), n // 3))
    return v, rng.integers(0, min(buckets, 4), n)


def phase_determinism(dev: str = "cuda") -> dict:
    """Each route that adds f32 sums in no fixed order (the grouped
    kernels' gsa_smem, gsa_global, gja_smem and gja_global routes, kms_main,
    seg_main, and the sorted tiers' ``runtime._segment_sum``), on an
    order-sensitive input and a random one, called twice: the same bits,
    the route's launches counted; the sums bit for bit their plain version
    ``ref.fixed_sum`` (``csrc/fixsum.cuh``'s integers; the segment sum runs
    it on the card), kms_main's by the tie-margin rule against its plain
    version (whose labels may differ at a tie); the wrapper's ms on the
    random input.  Returns the record per (route, input)."""
    import numpy as np
    import torch

    from repro_torch.core.expr import AggSpec, col, const
    from repro_torch.kernels import ops, ref
    from repro_torch.relational import runtime as rt

    rng = np.random.default_rng(28)
    aggs = (AggSpec("sum", col("v"), "s"), AggSpec("min", col("v"), "m"),
            AggSpec("count", const(1), "c"))
    ones = lambda k: torch.ones(k, dtype=torch.bool, device=dev)  # noqa: E731
    out = {}

    def record(name, kind, call, counts, plain):
        before = {k: dict(c) for k, c in counts.items()}
        a = call()
        sync(dev)
        took = {r: c[r] - before[k][r] for k, c in counts.items() for r in c
                if c[r] != before[k][r]}
        if took != ({name: 1} if counts else {}):
            raise AssertionError(f"determinism {name} {kind}: launched {took}")
        b = call()
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        if not same:
            x, y = a[0].reshape(-1).cpu(), b[0].reshape(-1).cpu()
            at = int(torch.nonzero(x.view(torch.int32) != y.view(torch.int32))[0])
            raise AssertionError(f"determinism {name} {kind}: two calls differ at {at}: "
                                 f"{x[at].item()!r} vs {y[at].item()!r}")
        err = plain(a)
        rec = {"launched": took, "same_bits": same, "against_plain": err}
        if kind == "random":
            rec["ms"] = cuda_ms(call)
        out[f"{name}/{kind}"] = rec
        log(f"determinism {name} {kind}: launched {json.dumps(took)}; two calls the same "
            f"bits; against its plain version {err}" + (f"; {rec['ms']:.4f} ms" if
                                                         "ms" in rec else ""))

    for name, nb in DETERMINISM_BUCKETS.items():
        for kind in ("ordered", "random"):
            v, g = _summands(kind, DETERMINISM_ROWS, nb, rng)
            cols = {"g": torch.from_numpy(g.astype(np.int32)).to(dev),
                    "v": torch.from_numpy(v).to(dev)}
            n = len(v)
            if name.startswith("gsa"):
                t = rt.VecTable(cols, ones(n))
                call = lambda t=t, nb=nb: _dense_sums(ops.grouped_select_agg(  # noqa: E731
                    t, None, ("g",), aggs, nb, ((0, nb - 1),), nb), nb)
                kv, kg = v, g
            else:
                m = 1 << 16
                fk = rng.integers(0, m + 1000, n).astype(np.int32)
                left = rt.VecTable(dict(cols, fk=torch.from_numpy(fk).to(dev)), ones(n))
                right = rt.VecTable({"rk": torch.arange(m, dtype=torch.int32, device=dev)},
                                    ones(m))
                call = lambda left=left, right=right, nb=nb, m=m: _dense_sums(  # noqa: E731
                    ops.grouped_join_agg(left, right, left_on=("fk",), right_on=("rk",),
                                         join_key_domains=((0, m - 1),), join_num_buckets=m,
                                         keys=("g",), aggs=aggs, max_groups=nb,
                                         key_domains=((0, nb - 1),), num_buckets=nb), nb)
                kv, kg = v[fk < m], g[fk < m]

            def plain(got, kv=kv, kg=kg, nb=nb, n=n, name=name):
                want = ref.fixed_sum(torch.from_numpy(kv), torch.from_numpy(kg), nb, rows=n)
                if not torch.equal(got[0].cpu(), want):
                    raise AssertionError(f"determinism {name}: not ref.fixed_sum's bits")
                return "ref.fixed_sum's bits"

            record(name, kind, call, {"gen": ops.GEN_LAUNCHES}, plain)
    n, d, k = DETERMINISM_KMS
    for kind in ("ordered", "random"):
        x = rng.normal(size=(n, d)).astype(np.float32)
        if kind == "ordered":
            x *= (10.0 ** rng.uniform(-2, 4, (n, 1))).astype(np.float32)
        c = x[rng.choice(n, k, replace=False)].copy()
        xt, ct = torch.from_numpy(x).to(dev), torch.from_numpy(c).to(dev)
        call = lambda xt=xt, ct=ct: ops.kmeans_step(xt, ct)  # noqa: E731

        def plain(got, xt=xt, ct=ct, x=x, c=c):
            from repro_torch import kmeans

            err = kmeans.check_step("determinism kms_main", got, ref.kmeans_step(xt, ct),
                                    kmeans.reference_step(x, c), KERNEL_RTOL)
            return f"the tie-margin rule at rtol {KERNEL_RTOL} (|Δ| ≤ {err:.4g})"

        record("kms_main", kind, call, {"kms": ops.KMEANS_LAUNCHES}, plain)
    n, d, kk = DETERMINISM_SEG
    for kind in ("ordered", "random"):
        x = rng.normal(size=(n, d)).astype(np.float32)
        ids = rng.integers(-1, kk + 1, n).astype(np.int32)
        if kind == "ordered":
            x *= (10.0 ** rng.uniform(-4, 8, (n, 1))).astype(np.float32)
            ids = rng.integers(0, 3, n).astype(np.int32)
        xt, it = torch.from_numpy(x).to(dev), torch.from_numpy(ids).to(dev)
        call = lambda xt=xt, it=it: (ops.segsum(xt, it, kk),)  # noqa: E731

        def plain(got, xt=xt, it=it):
            if not torch.equal(got[0].cpu(), ref.fixed_sum(xt.cpu(), it.cpu(), kk)):
                raise AssertionError("determinism seg_main: not ref.fixed_sum's bits")
            return "ref.fixed_sum's bits"

        record("seg_main", kind, call, {"seg": ops.SEGSUM_LAUNCHES}, plain)
    for kind in ("ordered", "random"):
        v, g = _summands(kind, DETERMINISM_ROWS, 7, rng)
        vt, gt = torch.from_numpy(v).to(dev), torch.from_numpy(g).to(dev)
        call = lambda vt=vt, gt=gt: (rt._segment_sum(vt, gt, 7),)  # noqa: E731

        def plain(got, vt=vt, gt=gt):
            if not torch.equal(got[0].cpu(), ref.fixed_sum(vt.cpu(), gt.cpu(), 7)):
                raise AssertionError("determinism segment_sum: not ref.fixed_sum's bits")
            want = rt._segment_sum(vt.cpu(), gt.cpu(), 7)
            scale = rt._segment_sum(vt.abs().cpu(), gt.cpu(), 7)
            gap = float(((got[0].cpu() - want).abs() / scale.clamp(min=1e-30)).max())
            if gap > 1e-5:
                raise AssertionError(f"determinism segment_sum: {gap} of Σ|v| from the CPU's")
            return f"ref.fixed_sum's bits, {gap:.3g} of Σ|v| from the CPU's chunked sum"

        record("segment_sum", kind, call, {}, plain)
    return out


def _dense_sums(r, nb: int):
    """A grouped result's sum column scattered back to its bucket ids, and
    its count and min columns as they came."""
    import torch

    s = torch.zeros(nb, dtype=torch.float32, device=r.valid.device)
    n = int(r.valid.sum())
    s[r.cols["g"][:n].long()] = r.cols["s"][:n]
    return s, r.cols["c"], r.cols["m"], r.valid


def phase_parallel(tables, frames) -> None:
    """The six queries with ``parallel=4``, counts set to 0 just before and
    read just after; Q1 and Q6 launch their kernel once per chunk.  Then
    each kernel call of this run against its plain version on the same
    inputs (replays, not counted)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.relational import tpch

    results, per_query, routes = {}, {}, {}
    with recording(TPCH_KERNELS) as captured:
        ops.reset_launches()
        for q, frame in frames.items():
            before = dict(ops.LAUNCHES)
            results[q], routes[q] = routed(frame.collect, device="cuda", parallel=PARALLEL)
            per_query[q] = {k: ops.LAUNCHES[k] - before[k] for k in before}
        launches = dict(ops.LAUNCHES)
        gen_launches = dict(ops.GEN_LAUNCHES)
    for q, got in results.items():
        check_query(q, got, tpch.REFERENCES[q](tables))
    check_routes(f"TPC-H path with parallel={PARALLEL}", launches, gen_launches, routes)
    # Q6: once per chunk; Q1: once per chunk, then once for the recombine
    for q, kname, want in (("q6", "fused_select_agg", PARALLEL),
                           ("q1", "grouped_select_agg", PARALLEL + 1)):
        if per_query[q][kname] != want:
            raise AssertionError(f"{q} with parallel={PARALLEL} launched {kname} "
                                 f"{per_query[q][kname]} times, not {want}")
    log(f"TPC-H path with parallel={PARALLEL}: six queries match the numpy references; "
        f"launches {launches}; per query {json.dumps(per_query)}")
    if len(captured) != sum(launches.values()):
        raise AssertionError(f"{len(captured)} wrapper calls recorded, {launches} launches")
    worst = {}
    for i, (name, args, kw) in enumerate(captured):
        err = compare_outputs(f"parallel {name}#{i}", getattr(ops, name)(*args, **kw),
                              getattr(ref, name)(*args, **kw))
        worst[name] = max(worst.get(name, 0.0), err)
    log(f"TPC-H path with parallel={PARALLEL}: its {len(captured)} kernel calls match their "
        f"plain versions; max abs error {json.dumps(worst)}")


#: the port's strategy for the JAX package's default lowering path
SORTED = {"groupby": "sorted", "join": "sorted"}
#: phase_dict's rows, and the distinct keys of its sparse group-by
DICT_ROWS, SPARSE_NDV = 1 << 22, 300
CITIES = ["athens", "berlin", "cairo", "dakar", "edinburgh", "florence", "geneva", "havana"]


def counted(fn, *args, **kw):
    """fn(*args, **kw), the kernel launches it made and the generated
    routes it took."""
    from repro_torch.kernels import ops

    before = dict(ops.LAUNCHES)
    out, took = routed(fn, *args, **kw)
    return out, {k: ops.LAUNCHES[k] - before[k] for k in before if ops.LAUNCHES[k] != before[k]}, took


def same_result(what: str, a, b) -> None:
    """Two query results (dicts of numpy arrays) equal bit for bit."""
    import numpy as np

    if set(a) != set(b):
        raise AssertionError(f"{what}: columns {sorted(a)} vs {sorted(b)}")
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
            raise AssertionError(f"{what}.{k}: not the same bits")


def split_ms(ctx, frame, reps: int, **kw):
    """Median (compile ms, execute ms) of ``frame`` on the card, the plan
    compiled anew each time (no cache); execute includes the result's copy
    to the host."""
    import torch

    from repro_torch.frontends.dataflow import _to_numpy

    frame.collect(device="cuda", cache=False, **kw)  # warm-up
    comp, run = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        compiled = ctx.compile(frame, device="cuda", cache=False, **kw)
        t1 = time.perf_counter()
        _to_numpy(compiled(ctx.sources("cuda"))[0])
        t2 = time.perf_counter()
        comp.append((t1 - t0) * 1e3)
        run.append((t2 - t1) * 1e3)
    return statistics.median(comp), statistics.median(run)


def phase_default_tiers(tables, ctx, frames, reps: int) -> None:
    """The six queries under the JAX package's default tiers (``SORTED``)
    with ``use_kernels``, sequential and with ``parallel=4``, each run with
    the counts set to 0 just before and read just after, against the numpy
    references: Q6, Q14 and Q19 launch ``fused_select_agg`` (its generated
    kernel), no query a grouped kernel.  Then Q1 and Q12 under
    ``fuse=unfused`` (the port's tiers, no fusion pass: the predicate and
    the join stay apart, the group-by alone on ``grouped_select_agg``).
    Then per query the compile and execute ms of the sorted tiers beside
    the direct ones."""
    from repro_torch.kernels import ops
    from repro_torch.relational import tpch

    for par in (None, PARALLEL):
        mode = "sequential" if par is None else f"parallel={PARALLEL}"
        results, per_query, routes = {}, {}, {}
        ops.reset_launches()
        for q, frame in frames.items():
            results[q], per_query[q], routes[q] = counted(
                frame.collect, device="cuda", parallel=par, strategy=SORTED)
        launches = dict(ops.LAUNCHES)
        for q, got in results.items():
            check_query(q, got, tpch.REFERENCES[q](tables))
        for q in EXPECTED["fused_select_agg"]:
            if not per_query[q].get("fused_select_agg") or "fsa_gen" not in routes[q]:
                raise AssertionError(f"sorted tiers {mode}: {q} launched {per_query[q]}, "
                                     f"routes {routes[q]}")
        if launches["grouped_select_agg"] or launches["grouped_join_agg"]:
            raise AssertionError(f"sorted tiers {mode}: a grouped kernel ran: {launches}")
        log(f"sorted tiers ({json.dumps(SORTED)}, use_kernels) {mode}: six queries match the "
            f"numpy references; launches per query {json.dumps(per_query)}; routes "
            f"{json.dumps(routes)}")

    ops.reset_launches()
    for q, want in (("q1", "grouped_select_agg"), ("q12", "grouped_select_agg")):
        got, launched, took = counted(frames[q].collect, device="cuda",
                                      strategy={"fuse": "unfused"})
        check_query(q, got, tpch.REFERENCES[q](tables))
        if not launched.get(want) or launched.get("grouped_join_agg"):
            raise AssertionError(f"fuse=unfused {q}: launched {launched}")
        log(f"fuse=unfused {q}: matches the numpy reference; launched {json.dumps(launched)}, "
            f"routes {took}")

    summary = {}
    for q, frame in frames.items():
        for par in (None, PARALLEL):
            mode = "sequential" if par is None else f"parallel{PARALLEL}"
            sc, se = split_ms(ctx, frame, reps, parallel=par, strategy=SORTED)
            dc, de = split_ms(ctx, frame, reps, parallel=par)
            summary.setdefault(mode, {})[q] = {"sorted_compile_ms": sc, "sorted_execute_ms": se,
                                               "direct_compile_ms": dc, "direct_execute_ms": de}
            log(f"tiers {q} {mode}: sorted compile {sc:.3f} ms, execute {se:.3f} ms; "
                f"direct compile {dc:.3f} ms, execute {de:.3f} ms (medians of {reps})")
    log("tiers: " + json.dumps(summary))


def phase_plan_cache(frames, reps: int) -> None:
    """Per query a fresh PlanCache: the first collect (a miss) and ``reps``
    repeats (hits), each timed, the repeats' compile alone too.  Fails
    unless every repeat hits and gives the miss's bits.  Counts set to 0
    just before, read just after: the three relational kernels ran."""
    import torch

    from repro_torch.compiler import PlanCache
    from repro_torch.kernels import ops

    summary = {}
    ops.reset_launches()
    for q, frame in frames.items():
        cache = PlanCache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = frame.collect(device="cuda", cache=cache)
        miss = (time.perf_counter() - t0) * 1e3
        hits, lookups = [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            got = frame.collect(device="cuda", cache=cache)
            t1 = time.perf_counter()
            if not frame._ctx.compile(frame, device="cuda", cache=cache).cache_hit:
                raise AssertionError(f"plan cache: {q} repeat compiled anew")
            lookups.append((time.perf_counter() - t1) * 1e3)
            hits.append((t1 - t0) * 1e3)
            same_result(f"plan cache {q} hit", got, first)
        if cache.stats != {"hits": 2 * reps, "misses": 1, "evictions": 0, "entries": 1}:
            raise AssertionError(f"plan cache {q}: {cache.stats}")
        summary[q] = {"miss_ms": miss, "hit_ms": statistics.median(hits),
                      "hit_min_ms": min(hits), "hit_max_ms": max(hits),
                      "hit_compile_ms": statistics.median(lookups), "stats": cache.stats}
        log(f"plan cache {q}: miss {miss:.3f} ms, hit median {statistics.median(hits):.3f} ms "
            f"over {reps} (min {min(hits):.3f}, max {max(hits):.3f}; the hit's compile "
            f"{statistics.median(lookups):.3f} ms); {json.dumps(cache.stats)}; every hit "
            "the miss's bits")
    launches = dict(ops.LAUNCHES)
    if not all(launches[k] for k in TPCH_KERNELS):
        raise AssertionError(f"plan cache: launches {launches}")
    log(f"plan cache: launches {json.dumps(launches)}")
    log("plan_cache: " + json.dumps(summary))


def _dict_shapes():
    """tests/test_dict_encoding.py's three shapes at DICT_ROWS rows (seed
    0): (name, tables, query builder, numpy oracle, strategies)."""
    import numpy as np

    from repro_torch.frontends.dataflow import count_, sum_

    rng = np.random.default_rng(0)
    n = DICT_ROWS
    city_idx = rng.integers(0, len(CITIES), n)
    amount = rng.gamma(2.0, 50.0, n).astype(np.float32)

    def city_q(ctx):
        return (ctx.table("sales").group_by("city", max_groups=16)
                .agg(sum_("amount").as_("rev"), count_().as_("n")).order_by("city"))

    def city_want():
        cnt = np.bincount(city_idx, minlength=len(CITIES))
        keep = cnt > 0
        return {"city": np.array(CITIES)[keep], "n": cnt[keep],
                "rev": np.bincount(city_idx, amount.astype(np.float64), len(CITIES))[keep]}

    domain = rng.integers(0, 1_500_000_000, SPARSE_NDV).astype(np.int32)
    k = domain[rng.integers(0, SPARSE_NDV, n)]
    v = rng.normal(size=n).astype(np.float32)

    def sparse_q(ctx):
        return (ctx.table("t").group_by("k", max_groups=512)
                .agg(sum_("v").as_("s"), count_().as_("n")).order_by("k"))

    def sparse_want():
        keys, inv = np.unique(k, return_inverse=True)
        return {"k": keys, "n": np.bincount(inv),
                "s": np.bincount(inv, v.astype(np.float64))}

    skus = np.array([f"sku-{i:04d}" for i in range(64)])
    pool = np.concatenate([skus, np.array([f"xsku-{i:04d}" for i in range(16)])])
    sku_idx = rng.integers(0, len(pool), n)
    qty = rng.integers(1, 10, n).astype(np.int32)

    def join_q(ctx):
        return (ctx.table("orders")
                .join(ctx.table("parts"), left_on=("sku",), right_on=("psku",))
                .group_by("sku", max_groups=128)
                .agg(sum_("qty").as_("q"), count_().as_("n")).order_by("sku"))

    def join_want():
        hit = sku_idx < len(skus)  # the xsku-* probes are in no build row
        cnt = np.bincount(sku_idx[hit], minlength=len(skus))
        keep = cnt > 0
        return {"sku": skus[keep], "n": cnt[keep],
                "q": np.bincount(sku_idx[hit], qty[hit].astype(np.float64), len(skus))[keep]}

    direct = {"groupby": "direct", "join": "hash", "encode": "dict"}
    return [
        ("string group-by", {"sales": {"city": np.array(CITIES)[city_idx], "amount": amount}},
         city_q, city_want, (direct,)),
        (f"sparse int group-by ({SPARSE_NDV} keys over a 1.5e9 span)",
         {"t": {"k": k, "v": v}}, sparse_q, sparse_want, (direct,)),
        ("string join, out-of-dictionary probes",
         {"orders": {"sku": pool[sku_idx], "qty": qty},
          "parts": {"psku": skus, "price": rng.gamma(2.0, 10.0, len(skus)).astype(np.float32)}},
         join_q, join_want, (direct, {"join": "sorted", "encode": "dict"})),
    ]


def check_frame(what: str, got, want) -> None:
    """A result against its numpy oracle, in order: strings and integers
    exact, floats within QUERY_RTOL of the f64 oracle."""
    import numpy as np

    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        if g.shape != w.shape:
            raise AssertionError(f"{what}.{k}: shape {g.shape} vs {w.shape}")
        if w.dtype.kind in "USO" or np.issubdtype(w.dtype, np.integer):
            if not np.array_equal(g.astype(w.dtype), w):
                raise AssertionError(f"{what}.{k}: values differ")
        else:
            np.testing.assert_allclose(g.astype(np.float64), w, rtol=QUERY_RTOL,
                                       err_msg=f"{what}.{k}")


def phase_dict(reps: int) -> None:
    """``encode=dict`` at DICT_ROWS rows: each shape under its strategies,
    counts set to 0 just before and read just after, against its numpy
    oracle; prints the lowered plan, the kernels and routes it launched,
    and its median ms over ``reps`` plan-cache hits."""
    import torch

    from repro_torch.frontends.dataflow import Context
    from repro_torch.kernels import ops

    for name, tables, build, oracle, strategies in _dict_shapes():
        t0 = time.perf_counter()
        ctx = Context(pad_to=256)
        for tname, data in tables.items():
            ctx.register(tname, data)
        ctx.sources("cuda")
        want = oracle()
        setup = time.perf_counter() - t0
        for strategy in strategies:
            frame = build(ctx)
            plan = ctx.compile(frame, device="cuda", strategy=strategy).program.opcodes()
            ops.reset_launches()
            got, launched, took = counted(frame.collect, device="cuda", strategy=strategy)
            check_frame(f"{name} {strategy}", got, want)
            if not launched or "vec.GroupAggSorted" in plan:
                raise AssertionError(f"{name} {strategy}: plan {plan}, launched {launched}")
            if "vec.DictEncode" in plan and not launched.get("grouped_select_agg"):
                raise AssertionError(f"{name}: no grouped_select_agg after DictEncode")
            fused = "vec.FusedJoinGroupAgg" in plan
            if fused != bool(launched.get("grouped_join_agg")):
                raise AssertionError(f"{name}: plan {plan}, launched {launched}")
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                frame.collect(device="cuda", strategy=strategy)
                times.append((time.perf_counter() - t1) * 1e3)
            join_note = ""
            if "join" in name:
                join_note = ("; FuseJoinGroupAgg fires" if fused else
                             "; FuseJoinGroupAgg does not fire (no HashJoinDirect → "
                             "GroupAggDirect pair)")
            log(f"dict {name}, {json.dumps(strategy)}: {len(next(iter(want.values())))} groups "
                f"match the numpy oracle; plan {plan}; launched {json.dumps(launched)}, "
                f"routes {took}{join_note}; median {statistics.median(times):.3f} ms over "
                f"{reps} (set-up {setup:.1f} s)")


def phase_sql(tables, ctx) -> None:
    """TPC-H Q6 and a grouped ORDER BY … LIMIT 3 through
    ``sql.query(ctx, ..., device="cuda")``, counts set to 0 just before and
    read just after: each parses to the Python frontend's program (the
    same fingerprint, so the plan cache serves the Python frame's plan),
    gives its bits and matches numpy."""
    import numpy as np

    from repro_torch.compiler import PLAN_CACHE
    from repro_torch.compiler.fingerprint import fingerprint
    from repro_torch.core.expr import col
    from repro_torch.frontends import sql
    from repro_torch.frontends.dataflow import count_, sum_
    from repro_torch.kernels import ops
    from repro_torch.relational import tpch

    d0, d1 = tpch._day(1994, 1, 1), tpch._day(1995, 1, 1)
    q6 = (f"SELECT sum(l_extendedprice * l_discount) AS revenue FROM lineitem WHERE "
          f"l_shipdate >= {d0} AND l_shipdate < {d1} AND l_discount BETWEEN 0.05 AND 0.07 "
          "AND l_quantity < 24.0")
    grouped = ("SELECT sum(l_quantity) AS sum_qty, sum(l_extendedprice) AS sum_base_price, "
               f"count(*) AS count_order FROM lineitem WHERE l_shipdate <= {tpch.Q1_CUTOFF} "
               "GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus LIMIT 3")
    py_grouped = (ctx.table("lineitem").filter(col("l_shipdate") <= tpch.Q1_CUTOFF)
                  .group_by("l_returnflag", "l_linestatus", max_groups=4096)
                  .agg(sum_("l_quantity").as_("sum_qty"),
                       sum_("l_extendedprice").as_("sum_base_price"),
                       count_().as_("count_order"))
                  .order_by("l_returnflag", "l_linestatus").limit(3))
    li = tables["lineitem"]
    keep = li["l_shipdate"] <= tpch.Q1_CUTOFF
    flag, status = li["l_returnflag"][keep], li["l_linestatus"][keep]
    groups = sorted(set(zip(flag.tolist(), status.tolist())))[:3]
    masks = [(flag == f) & (status == s) for f, s in groups]
    want_grouped = {
        "l_returnflag": np.array([f for f, _ in groups]),
        "l_linestatus": np.array([s for _, s in groups]),
        "sum_qty": np.array([li["l_quantity"][keep][m].sum(dtype=np.float64) for m in masks]),
        "sum_base_price": np.array([li["l_extendedprice"][keep][m].sum(dtype=np.float64)
                                    for m in masks]),
        "count_order": np.array([int(m.sum()) for m in masks])}

    ops.reset_launches()
    for name, text, frame, want, kernel in (
            ("q6", q6, tpch.q6(ctx), tpch.REFERENCES["q6"](tables), "fused_select_agg"),
            ("grouped order-by limit 3", grouped, py_grouped, want_grouped,
             "grouped_select_agg")):
        if fingerprint(sql.parse(text, ctx).program()) != fingerprint(frame.program()):
            raise AssertionError(f"sql {name}: not the Python frontend's program")
        py, py_launched, _ = counted(frame.collect, device="cuda")
        hits = PLAN_CACHE.hits
        got, launched, took = counted(sql.query, ctx, text, device="cuda")
        if PLAN_CACHE.hits != hits + 1 or not launched.get(kernel):
            raise AssertionError(f"sql {name}: cache hits {hits} → {PLAN_CACHE.hits}, "
                                 f"launched {launched}")
        same_result(f"sql {name}", got, py)
        check_frame(f"sql {name}", got, want)
        log(f"sql {name}: the Python frontend's plan (a plan-cache hit) and bits, matches "
            f"numpy; launched {json.dumps(launched)}, routes {took}")
    log(f"sql: launches {json.dumps(dict(ops.LAUNCHES))}")


def phase_edges_attention() -> None:
    """flash_attention against its plain version at the edges: S ∈ {1, 77,
    200, 2048}, D ∈ {32, 64, 128}, group ∈ {1, 6}, f32 and bf16, causal or
    not, windows 64 and 128, non-default scales; then D = 112 (Zamba2-7B's
    shared attention: the tensor-core kernel's D = 128 tile, zero-filled)
    at every combination of f32 and bf16, causal and windowed (128),
    group 1 and 4, S ∈ {1, 200, 2048}, each printing its route."""
    import itertools

    import numpy as np
    import torch

    from repro_torch.kernels import ops, ref

    variants = [(True, None, None), (False, None, None), (True, 64, None),
                (False, 128, 0.3), (True, 128, None), (True, None, 0.05)]
    rng = np.random.default_rng(9)
    cases = [(s, d, group, *variants[i % len(variants)],
              (torch.float32, torch.bfloat16)[(i // len(variants)) % 2])
             for i, (s, d, group) in enumerate(itertools.product((1, 77, 200, 2048),
                                                                 (32, 64, 128), (1, 6)))]
    cases += [(s, 112, group, True, window, None, dtype) for s, group, window, dtype in
              itertools.product((1, 200, 2048), (1, 4), (None, 128),
                                (torch.float32, torch.bfloat16))]
    shares = []
    for s, d, group, causal, window, scale, dtype in cases:
        q, k, v = (torch.tensor(rng.normal(size=(2, h, s, d)), dtype=dtype, device="cuda")
                   for h in (2 * group, 2, 2))
        kw = dict(causal=causal, window=window, sm_scale=scale)
        what = f"flash_attention[S={s},D={d},group={group},{dtype},{kw}]"
        got = ops.flash_attention(q, k, v, **kw)
        err, share = check_attention(what, got, ref.flash_attention(q, k, v, **kw), v)
        route = FA_TENSOR_CORE if dtype == torch.bfloat16 else FA_CUDA_CORE
        row = {"case": what, "route": route, "max_abs_err": err, "bound_share": share}
        if dtype == torch.bfloat16:
            row["max_abs_from_tiled"] = tiled_gap(got, (q, k, v), kw)
        shares.append(row)
    torch.cuda.synchronize()
    log("edge cases, flash_attention: " + json.dumps(shares))
    worst = {t: max(r["bound_share"] for r in shares if t in r["case"])
             for t in ("float32", "bfloat16")}
    log(f"edge cases: {len(cases)} flash_attention calls match their plain version; worst share "
        f"of the bound: f32 (fa_main) {worst['float32']:.4f}, bf16 (fa_wgmma) "
        f"{worst['bfloat16']:.4f}")
    d112 = [r for r in shares if ",D=112," in r["case"]]
    log(f"edge cases at D = 112: {len(d112)} calls match their plain version; worst share of the "
        "bound: " + ", ".join(
            f"{t} ({r}) {max(x['bound_share'] for x in d112 if x['route'] == r):.4f}"
            for t, r in (("f32", FA_CUDA_CORE), ("bf16", FA_TENSOR_CORE))))


def _watched(model):
    """The model with its prefill and decode wrapped to keep each call's
    logits (B, V) in ``calls``, one list per wave: the logits are made
    anyway, so this adds no device work."""
    from dataclasses import replace

    calls = []

    def prefill(p, b, cap):
        out = model.prefill(p, b, cap)  # an enc-dec prefill gives the cache alone
        calls.append([out[0]] if isinstance(out, tuple) else [])
        return out

    def init_state(bsz, cap, device=None):  # a wave with no prefill (the vlm family's)
        calls.append([])
        return model.init_state(bsz, cap, device)

    def decode(p, cache, toks):
        logits, cache = model.decode(p, cache, toks)
        calls[-1].append(logits)
        return logits, cache

    return replace(model, prefill=prefill, decode=decode, init_state=init_state), calls


def _serve_once(model, params, requests, gen: int = SERVE_GEN, *, batch: int = SERVE_BATCH,
                prompt_len: int = SERVE_PROMPT, cap: int = SERVE_CAP, frames_rng=None):
    """One traced ``serve_loop`` over ``requests`` through ``make_run_wave``;
    returns (outputs, the logits of each call per wave, tracer, wall s)."""
    import torch

    from repro_torch.launch.serve import make_run_wave, serve_loop
    from repro_torch.obs.trace import tracing

    watched, calls = _watched(model)
    run_wave = make_run_wave(watched, params, batch=batch, prompt_len=prompt_len, gen=gen,
                             cache_cap=cap, device="cuda", frames_rng=frames_rng)
    with tracing() as tracer:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve_loop(requests, run_wave, batch=batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, calls, tracer, wall


def fed_same(glog, wlog):
    """Per wave, per request: how many of the calls (the prefill, then each
    decode step) two serving runs fed the same tokens: call t saw the
    greedy tokens of calls < t, so the count ends one past the first call
    whose tokens differ."""
    import torch

    out = []
    for g, w in zip(glog, wlog):
        gl, wl = torch.stack(g), torch.stack(w)                     # (steps, B, V)
        differ = (gl.argmax(-1) != wl.argmax(-1)).cpu()             # (steps, B)
        row = []
        for j in range(gl.shape[1]):
            bad = differ[:, j].nonzero()
            row.append(int(bad[0]) + 1 if len(bad) else gl.shape[0])
        out.append(row)
    return out


def path_gap(glog, wlog):
    """Two serving runs' logits (per wave, per call (B, V)): (largest |Δ| of
    the prefill logits, largest |Δ| over every step both paths were fed
    the same tokens — the prefill, then each decode step while their
    greedy tokens agree —, the number of such steps, the std of the second
    run's prefill logits)."""
    import torch

    pre = worst = 0.0
    same = 0
    for g, w, fed in zip(glog, wlog, fed_same(glog, wlog)):
        gl, wl = torch.stack(g), torch.stack(w)                     # (steps, B, V)
        pre = max(pre, float((gl[0] - wl[0]).abs().max()))
        for j, n in enumerate(fed):
            worst = max(worst, float((gl[:n, j] - wl[:n, j]).abs().max()))
            same += n
    std = float(torch.cat([w[0].flatten() for w in wlog]).std())
    return pre, worst, same, std


def logit_rms_gap(glog, wlog) -> float:
    """The RMS of two runs' logit differences over every step both were fed
    the same tokens (as ``path_gap`` counts them)."""
    import torch

    sq, n = 0.0, 0
    for g, w, fed in zip(glog, wlog, fed_same(glog, wlog)):
        gl, wl = torch.stack(g), torch.stack(w)                     # (steps, B, V)
        for j, k in enumerate(fed):
            d = (gl[:k, j] - wl[:k, j]).double()
            sq += float((d * d).sum())
            n += d.numel()
    return (sq / n) ** 0.5


def exact_attention(q, k, v, *, causal=True, window=None, sm_scale=None):
    """Attention in f64, rounded once to q's dtype: the exactly rounded
    answer, the yardstick of how far correct bf16 paths drift apart.  One
    batch row and at most EXACT_SLICE_BYTES of f64 scores at a time: the
    slices are independent, so the answer is one call's (Granite-34B's
    (4, 48, 2048, 2048) scores are 6.4 GB in f64, and a call makes about
    three such tensors)."""
    import math

    import torch

    from repro_torch.kernels import ref

    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    mask = ref.attention_mask(s, causal, window, q.device)
    step = max(1, EXACT_SLICE_BYTES // (s * s * 8))
    out = torch.empty_like(q)
    for i in range(b):
        for h in range(0, hq, step):
            kv = torch.arange(h, min(h + step, hq), device=q.device) // group
            logits = (q[i, h:h + step].double() * scale) @ k[i, kv].double().transpose(-1, -2)
            p = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
            out[i, h:h + step] = (p @ v[i, kv].double()).to(q.dtype)
    return out


def ref_by_row(q, k, v, **kw):
    """``ref.flash_attention`` one batch row at a time: the same function
    (rows are independent), with one row's scores in memory at once
    (Granite-34B's (4, 48, 2048, 2048) f32 scores whole, about three live
    at once, would sit beside its 67.32 GB of weights)."""
    import torch

    from repro_torch.kernels import ref

    return torch.cat([ref.flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], **kw)
                      for i in range(q.shape[0])])


def compare_paths(label: str, got, want, exact, noise: float, gen: int = SERVE_GEN, *,
                  batch: int = SERVE_BATCH, lead: int = 1) -> dict:
    """One serving run (outputs, per-wave logits) against the plain path's:
    the logits of every step both were fed the same tokens within the
    larger of LOGIT_STD_SHARE of the first call's logits' std and
    NOISE_FACTOR × ``noise``, and each request's tokens its logits' argmax
    (the calls after the ``lead`` ones: 1, the prefill's logits, or 0 for a
    prefill that gives none).  Reports the run's own distance from the
    ``exact`` run, and per request the step at which its tokens first leave
    the plain path's with the plain path's top-2 logit gap there."""
    import torch

    (gout, glog), (wout, wlog) = got, want
    pre, worst, same, std = path_gap(glog, wlog)
    limit = max(LOGIT_STD_SHARE * std, NOISE_FACTOR * noise)
    if not worst <= limit:
        raise AssertionError(f"{label}: logits differ by {worst} over {same} steps fed the same "
                             f"tokens, over {limit} (the larger of {LOGIT_STD_SHARE} of their "
                             f"std {std} and {NOISE_FACTOR} × the noise floor {noise})")
    _, to_exact, exact_steps, _ = path_gap(glog, exact)
    diverged = []
    for wave, (g, w) in enumerate(zip(glog, wlog)):
        gl, wl = torch.stack(g), torch.stack(w)                     # (steps, B, V)
        top2 = wl.topk(2, dim=-1).values
        gaps = (top2[..., 0] - top2[..., 1]).cpu()                  # (steps, B)
        gseq, wseq = gl.argmax(-1).cpu(), wl.argmax(-1).cpu()
        for j in range(gseq.shape[1]):
            rid = wave * batch + j
            # the decode steps' tokens are what serve_loop returned
            if not (gseq[lead:, j].numpy() == gout[rid]).all() or not (
                    wseq[lead:, j].numpy() == wout[rid]).all():
                raise AssertionError(f"{label}: request {rid}'s tokens are not its logits' argmax")
            bad = (gseq[:, j] != wseq[:, j]).nonzero()
            if len(bad):
                diverged.append((rid, int(bad[0]), round(float(gaps[int(bad[0]), j]), 6)))
    steps = len(gout) * (gen + lead)
    log(f"serving path {label}: logits max |Δ| {worst:.6g} over the {same} of {steps} steps fed "
        f"the same tokens (limit {limit:.6g}; std {std:.6g}, {worst / std:.4f} of it; noise "
        f"floor {noise:.6g}); prefill logits max |Δ| {pre:.6g}; from the exact run "
        f"{to_exact:.6g} over {exact_steps} steps; tokens leave the plain path's in "
        f"{len(diverged)} of {len(gout)} requests, (request, step, plain top-2 gap): {diverged}")
    return {"prefill_max_abs": pre, "logit_std": std, "limit": limit, "max_abs": worst,
            "same_token_steps": same, "max_abs_from_exact": to_exact,
            "same_token_steps_exact": exact_steps, "diverged": diverged}


def serve_cell(arch: str, smi: str, *, layers_cut: int = 0,
               requests_n: int = SERVE_REQUESTS, gen: int = SERVE_GEN, chunked: bool = True,
               check_block: bool = False, sample_calls: bool = False):
    """A config served at full width (depth cut to ``layers_cut`` where
    given) with attn_mode="pallas" through ``make_run_wave`` and
    ``serve_loop`` after a warm-up wave, the launch counts set to 0 just
    before and read just after (``flash_attention`` once per layer per
    wave; every call recorded, or with ``sample_calls`` the first wave's
    first and last layer's); then the
    same parameters and prompts with the plain attention (``ref``, one
    batch row at a time: ``ref_by_row``), with ``chunked`` where asked, and
    with f64 attention (the noise floor), each path held to the plain one
    by phase 18's rule.  ``init``'s temporaries are held to two f32
    copies of its largest single draw (one layer of a stacked leaf), and
    the phase's peak to the card's memory.  For an MoE config the
    plain and chunked paths first run as they fall: each path's routing
    flips against the plain path are counted and checked, and the logits
    they move printed; then f64 attention and each path run with the
    routing pinned to the plain path's, and the rule holds those.  Also
    the drop share per layer in prefill, the floors and, with
    ``check_block``, ``moe_block`` alone on the layer-0 input.  Returns
    (flash_attention's launches, the recorded kernel calls, the report, one
    wave to profile)."""
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Request, make_run_wave
    from repro_torch.models.api import build_model

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    base = get_config(arch)
    if layers_cut:
        base = replace(base, n_layers=layers_cut)
    t0 = time.perf_counter()
    model = build_model(replace(base, attn_mode="pallas"))
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    param_bytes = sum(_bytes(t) for t in _leaves(params))
    init_temp = torch.cuda.max_memory_allocated() - held - param_bytes
    draw = _largest_draw(params)
    if init_temp > 8 * draw + (1 << 26):
        raise AssertionError(f"{arch}: init held {init_temp / 1e9:.3f} GB of temporaries, over "
                             f"two f32 copies of its largest single draw ({draw} elements)")
    log(f"init {arch}: {init_temp / 1e9:.3f} GB of temporaries beside the "
        f"{param_bytes / 1e9:.3f} GB of parameters; largest single draw {draw} elements "
        f"({4 * draw / 1e9:.3f} GB in f32)")
    prompts = np.random.default_rng(0).integers(0, base.vocab, (requests_n, SERVE_PROMPT))

    def requests():
        return [Request(rid=i, prompt=prompts[i]) for i in range(requests_n)]

    log(f"serving {arch}{f' at {layers_cut} layers' if layers_cut else ''}: "
        f"{n_params / 1e9:.4f} B parameters (ModelConfig.n_params(), which counts no norm or "
        f"bias: {base.n_params()}), {base.n_active_params() / 1e9:.4f} B active per token "
        f"({base.dtype}, {param_bytes / 1e9:.3f} GB; "
        f"{held / 1e9:.2f} GB held by earlier phases); {requests_n} requests × {SERVE_PROMPT} "
        f"prompt tokens, batch {SERVE_BATCH}, {gen} generated, cache {SERVE_CAP}; set-up "
        f"{time.perf_counter() - t0:.1f} s")
    wave = make_run_wave(model, params, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=gen,
                         cache_cap=SERVE_CAP, device="cuda")
    wave(requests()[:SERVE_BATCH])  # warm-up: library handles, the allocator, first launches
    torch.cuda.reset_peak_memory_stats()
    n_l = base.n_layers
    waves = -(-requests_n // SERVE_BATCH)
    keep = (lambda i: i in (0, n_l - 1)) if sample_calls else None
    with recording(("flash_attention",), keep=keep) as captured, routing() as rec:
        ops.reset_launches()
        out, logits, tracer, wall = _serve_once(model, params, requests(), gen)
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() - held
    if sorted(out) != list(range(requests_n)):
        raise AssertionError(f"{arch}: served {sorted(out)} of {requests_n} requests")
    for rid, toks in out.items():
        if toks.shape != (gen,) or not ((toks >= 0) & (toks < base.vocab)).all():
            raise AssertionError(f"{arch} request {rid}: tokens {toks}")
    if not all(bool(torch.isfinite(x).all()) for w in logits for x in w):
        raise AssertionError(f"{arch}: the serving path gave non-finite logits")
    if launches != {"flash_attention": n_l * waves} or (keep is None
                                                         and len(captured) != n_l * waves):
        raise AssertionError(f"{arch}: launched {launches}, not flash_attention {n_l} per wave")
    if len(rec["calls"]) != (waves * (1 + gen) * n_l if base.is_moe else 0):
        raise AssertionError(f"{arch}: {len(rec['calls'])} moe_route calls")
    log(f"serving path {arch} (pallas): {len(out)} requests served, {waves} waves; launches "
        f"{launches}; peak allocated {peak / 1e9:.3f} GB above the {held / 1e9:.2f} GB held")
    report = {"card": smi, "pallas": _serve_numbers(tracer, wall, len(out), gen),
              "peak_allocated_gb": peak / 1e9, "held_gb": held / 1e9,
              "init_temporaries_gb": init_temp / 1e9,
              "n_params": n_params, "n_active_params": base.n_active_params()}
    # the plain path and chunked as they run (for an MoE config: each
    # path's routing flips against the plain path's, and the logits those
    # flips move)
    runs = {"pallas": (out, logits, rec)}
    modes = {"ref": ref_by_row, "chunked": "chunked"}
    for name in ("ref", "chunked") if chunked else ("ref",):
        with routing() as r:
            res = _serve_once(build_model(replace(base, attn_mode=modes[name])), params,
                              requests(), gen)
        runs[name] = (res[0], res[1], r)
        report[name] = _serve_numbers(res[2], res[3], len(res[0]), gen)
    plain = runs["ref"]
    paths = [n for n in runs if n != "ref"]
    if base.is_moe:
        report["routing"], report["unpinned_vs_ref"] = {}, {}
        for name in paths:
            report["routing"][name] = routing_flips(
                f"{arch} {name} vs ref", runs[name][2]["calls"], plain[2]["calls"],
                fed_same(runs[name][1], plain[1]), n_l, base.top_k)
            pre, worst, same, std = path_gap(runs[name][1], plain[1])
            report["unpinned_vs_ref"][name] = {"prefill_max_abs": pre, "max_abs": worst,
                                               "same_token_steps": same, "logit_std": std}
            log(f"serving path {arch} {name} vs ref, routing as it falls: logits max |Δ| "
                f"{worst:.6g} ({worst / std:.4f} of their std) over {same} steps fed the same "
                f"tokens, prefill {pre:.6g}")
    # phase 18's rule: f64 attention (the noise floor), then each path; an
    # MoE config's runs with the routing pinned to the plain path's
    held_to = {name: runs[name][:2] for name in paths}
    pin = plain[2]["calls"] if base.is_moe else None
    for name, mode in (("exact", exact_attention),
                       *(((n, n) for n in paths) if base.is_moe else ())):
        with routing(pin=pin):
            res = _serve_once(build_model(replace(base, attn_mode=mode)), params, requests(),
                              gen)
        held_to[name] = res[:2]
    pinned = " (routing pinned to the plain path's)" if base.is_moe else ""
    _, noise, same, std = path_gap(plain[1], held_to["exact"][1])
    report["noise_floor"] = {"max_abs": noise, "same_token_steps": same, "logit_std": std}
    log(f"serving path {arch} noise floor{pinned}: the plain path's logits differ from those "
        f"with exactly rounded (f64) prefill attention by up to {noise:.6g} ({noise / std:.4f} "
        f"of their std {std:.6g}) over the {same} steps fed the same tokens")
    for name in paths:
        report[f"{name}_vs_ref"] = compare_paths(f"{arch} {name} vs ref{pinned}", held_to[name],
                                                 plain[:2], held_to["exact"][1], noise, gen)
    del held_to
    if base.is_moe:
        drops = drop_shares(rec, n_l, gen)
        report["prefill_dropped_share_per_layer"] = drops
        report["bounds"] = b = moe_bounds(base, params)
        r = report["pallas"]
        log(f"serving {arch} ({smi}): prefill {r['prefill_ms_per_wave']:.3f} ms per wave "
            f"(expert products {b['prefill_expert_flop']:.4g} FLOP on {b['prefill_slots']} "
            f"slots for {b['prefill_choices']} choices, C={b['prefill_capacity']}: floor "
            f"{b['prefill_expert_floor_ms']:.3f} ms at 989 TFLOP/s); decode "
            f"{r['decode_ms_per_step']:.3f} ms per step (reads "
            f"{b['decode_weight_bytes'] / 1e9:.2f} GB of weights, C={b['decode_capacity']}: "
            f"floor {b['decode_floor_ms']:.3f} ms at 3.35 TB/s); {r['tokens_per_s']:.6g} "
            f"generated tokens/s; request latency p50 {r['latency_p50_s']:.4f} s, p99 "
            f"{r['latency_p99_s']:.4f} s; peak {peak / 1e9:.3f} GB; prefill choices dropped per "
            f"layer: mean {statistics.mean(drops):.4f}, max {max(drops):.4f}")
        for name in paths[1:] + ["ref"]:
            x = report[name]
            log(f"serving {arch} ({name} attention): prefill {x['prefill_ms_per_wave']:.3f} ms "
                f"per wave, decode {x['decode_ms_per_step']:.3f} ms per step, "
                f"{x['tokens_per_s']:.6g} tokens/s")
    else:
        r = report["pallas"]
        flop = 2 * n_params * SERVE_BATCH * SERVE_PROMPT
        report["bounds"] = {"prefill_flop": flop, "prefill_floor_ms": flop / PEAK_BF16_TC * 1e3,
                            "decode_weight_bytes": param_bytes,
                            "decode_floor_ms": param_bytes / PEAK_BYTES * 1e3}
        log(f"serving {arch} ({smi}): prefill {r['prefill_ms_per_wave']:.3f} ms per wave "
            f"({flop / r['prefill_ms_per_wave'] / 1e9:.1f} TFLOP/s of 2·N·tokens = {flop:.4g}; "
            f"floor {flop / PEAK_BF16_TC * 1e3:.3f} ms at 989 TFLOP/s); decode "
            f"{r['decode_ms_per_step']:.3f} ms per step (reads {param_bytes / 1e9:.2f} GB of "
            f"weights: floor {param_bytes / PEAK_BYTES * 1e3:.3f} ms at 3.35 TB/s); "
            f"{r['tokens_per_s']:.6g} generated tokens/s; request latency p50 "
            f"{r['latency_p50_s']:.4f} s, p99 {r['latency_p99_s']:.4f} s")
        for name in paths[1:] + ["ref"]:
            x = report[name]
            log(f"serving {arch} ({name} attention): prefill {x['prefill_ms_per_wave']:.3f} ms "
                f"per wave, decode {x['decode_ms_per_step']:.3f} ms per step, "
                f"{x['tokens_per_s']:.6g} tokens/s")
    phase_peak = torch.cuda.max_memory_allocated()
    card = torch.cuda.get_device_properties(0).total_memory
    report["phase_peak_gb"], report["card_gb"] = phase_peak / 1e9, card / 1e9
    log(f"serving phase {arch}: peak allocated {phase_peak / 1e9:.3f} GB over every path "
        f"({held / 1e9:.2f} GB held by earlier phases) of the card's {card / 1e9:.3f} GB")
    if check_block:
        x0 = rec["first"].reshape(SERVE_BATCH, SERVE_PROMPT, base.d_model)
        lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
        report["moe_block"] = check_moe_block(base, lp, x0)
    del runs, rec, logits, out
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"{arch}: " + json.dumps(report))
    log(f"serving phase {arch} took {report['phase_s']:.1f} s")
    return (launches["flash_attention"], list(captured), report,
            lambda: wave(requests()[:SERVE_BATCH]))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _largest_draw(params) -> int:
    """The elements of ``init``'s largest single draw: one layer of a
    leaf stacked under ``"layers"`` (``stacked_init``), any other leaf
    whole."""
    return max([t[0].numel() for t in _leaves(params["layers"])]
               + [t.numel() for k, v in params.items() if k != "layers" for t in _leaves(v)])


def _serve_numbers(tracer, wall: float, served: int, gen: int = SERVE_GEN,
                   wave_tokens: int = SERVE_BATCH * SERVE_PROMPT) -> dict:
    """The serving numbers of one run from the port's tracer: medians over
    the waves (prefill, where the family has one, of ``wave_tokens`` prompt
    tokens or frames) and the steps (decode), latency percentiles."""
    prefill = tracer.histograms.get("serve.prefill_s", [])
    decode = tracer.histograms["serve.decode_step_s"]
    lat = tracer.histogram_summary("serve.request_latency_s")
    out = {"decode_ms_per_step": statistics.median(decode) * 1e3,
           "decode_ms_min": min(decode) * 1e3, "decode_ms_max": max(decode) * 1e3,
           "tokens_per_s": served * gen / wall,
           "wall_s": wall, "latency_p50_s": lat["p50"], "latency_p99_s": lat["p99"]}
    if prefill:
        out.update({"prefill_ms_per_wave": statistics.median(prefill) * 1e3,
                    "prefill_ms_all": [x * 1e3 for x in prefill],
                    "prefill_tokens_per_s": wave_tokens / statistics.median(prefill)})
    return out


def _library_ms(name: str, args: tuple, kw: dict):
    """The one PyTorch call that computes the kernel's function, timed,
    where there is one: ``index_add_`` for segsum (ids in range here),
    ``scaled_dot_product_attention`` for flash_attention (the window as a
    boolean mask)."""
    import torch

    if name == "flash_attention":
        from repro_torch.kernels import ref

        q, k, v = args
        causal, window = kw.get("causal", True), kw.get("window")
        sdpa = dict(scale=kw.get("sm_scale"), enable_gqa=True)
        if window is None:
            sdpa["is_causal"] = causal
        else:
            sdpa["attn_mask"] = ref.attention_mask(q.shape[2], causal, window, q.device)
        return cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, **sdpa))
    if name != "segsum":
        return None
    data, ids, k = args
    if not bool(((ids >= 0) & (ids < k)).all()):
        return None
    return cuda_ms(lambda: torch.zeros((k, data.shape[1]), dtype=data.dtype,
                                       device=data.device).index_add_(0, ids, data))


def phase_kernels(captured, launches, pool):
    """Each kernel against its plain version on the paths' inputs; then
    which kernel a served attention call runs (``phase_attention_route``)."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kmeans import check_step, reference_step

    rows = []
    agg = {}
    for i, (name, args, kw) in enumerate(captured):
        kern, plain = getattr(ops, name), getattr(ref, name)
        (got, took), want = routed(kern, *args, **kw), plain(*args, **kw)
        extra = {}
        if name == "kmeans_step":
            x, c = (a.cpu().numpy() for a in args)
            err = check_step(f"kmeans_step#{i}", got, want, reference_step(x, c, pool.map),
                             KERNEL_RTOL)
            # the card's read rate on the same bytes: a floor, not a library call
            extra = {"read_floor_ms": cuda_ms(lambda: torch.sum(args[0]))}
        elif name == "segsum":
            err = check_segsum(f"segsum#{i}", got, *args)
            took = [ops.segsum_route(args[0].shape[1], args[2])]
        elif name == "flash_attention":
            err, share = check_attention(f"flash_attention#{i}", got, want, args[2])
            extra = {"bound_share": share}
            if args[0].dtype == torch.bfloat16:
                extra["max_abs_from_tiled"] = tiled_gap(got, args, kw)
        else:
            err = compare_outputs(f"{name}#{i}", got, want)
        ms = cuda_ms(lambda: kern(*args, **kw))
        pms = cuda_ms(lambda: plain(*args, **kw))
        lib = _library_ms(name, args, kw)
        nbytes, nops = work(name, args, kw)
        if name in TPCH_KERNELS:
            nbytes += result_bytes(want)
            shape = {"rows": args[0].capacity, "join_buckets": kw.get("join_num_buckets"),
                     "buckets": kw.get("num_buckets",
                                       args[-1] if name == "grouped_select_agg" else None)}
        else:
            shape = {"shapes": [list(a.shape) for a in args if hasattr(a, "shape")]}
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, nops / ops_peak(args) * 1e3
        if took:
            shape["route"] = took[0]
        rows.append({"kernel": name, "call": i, **shape, "ms": ms, "plain_ms": pms,
                     "library_ms": lib, "bytes": nbytes, "ops": nops,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_f32_ms": max(t_bytes, nops / PEAK_F32 * 1e3), "max_abs_err": err,
                     **extra})
        a = agg.setdefault(name, {"ms": 0.0, "plain_ms": 0.0, "library_ms": None,
                                  "bytes_ms": 0.0, "ops_ms": 0.0, "ops_f32_ms": 0.0,
                                  "err": 0.0})
        a["ms"] += ms
        a["plain_ms"] += pms
        if lib is not None:
            a["library_ms"] = (a["library_ms"] or 0.0) + lib
        a["bytes_ms"] += t_bytes
        a["ops_ms"] += t_ops
        a["ops_f32_ms"] += nops / PEAK_F32 * 1e3
        a["err"] = max(a["err"], err)
        for key, x in extra.items():
            a[key] = a.get(key, 0.0) + x if key == "read_floor_ms" else max(a.get(key, 0.0), x)
    log("kernel calls: " + json.dumps(rows))
    own = phase_attention_route([c for c in captured if c[0] == "flash_attention"])
    by_shape = {}
    for r in rows:
        if r["kernel"] == "flash_attention":
            by_shape.setdefault(json.dumps(r["shapes"][:2]), []).append(r)
    for shape, rs in by_shape.items():
        log(f"flash_attention at q, k {shape}: {len(rs)} calls; mean wrapper "
            + ", ".join(f"{k} {statistics.mean(r[k] for r in rs):.4f}"
                        for k in ("ms", "plain_ms", "library_ms", "bound_ms"))
            + f" (library: SDPA with enable_gqa); own device ms of the first call "
            + (f"{own[shape]:.4f}" if shape in own else "not measured (not bf16)"))
    out = []
    for name in REPLACES:
        a = agg[name]
        t_bytes, t_ops = a["bytes_ms"], a["ops_ms"]
        out.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": a["err"], "ms": a["ms"], "plain_ms": a["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": a["library_ms"],
        })
        if name in GENERATED_BY:
            out[-1]["generated_by"] = GENERATED_BY[name]
        if a["ops_f32_ms"] != t_ops:  # bf16 operands: the f32 convention's bound beside
            out[-1]["bound_f32_ms"] = max(t_bytes, a["ops_f32_ms"])
        out[-1].update({k: a[k] for k in ("bound_share", "max_abs_from_tiled", "read_floor_ms")
                        if k in a})
    log("kernels vs plain versions on the paths' inputs: all match")
    km = agg["kmeans_step"]
    log(f"read floor: torch.sum over the points of the {launches['kmeans_step'] // (KMEANS_STEPS + 1)}"
        f" k-means path calls of a step, {km['read_floor_ms']:.4f} ms "
        f"({km['bytes_ms'] * PEAK_BYTES / 1e3 / km['read_floor_ms'] / 1e9:.4g} TB/s); "
        f"kmeans_step wrapper {km['ms']:.4f} ms, {km['ms'] / km['read_floor_ms']:.3f}x the floor, "
        f"bound {km['bytes_ms']:.4f} ms")
    next(r for r in out if r["name"] == "flash_attention")["own_ms_by_shape"] = own
    return out


def phase_attention_route(calls) -> dict:
    """The first served flash_attention call (bf16) of each q and k shape
    (head width 128 from the dense, MoE and VLM models, 112 from Zamba2-7B,
    64 from Whisper-base), all in one torch.profiler window after a warm-up
    window, each three times: each call's device kernel must be the
    tensor-core one for its width (``fa_wgmma<D>``), and none the CUDA-core
    one.  The calls run in order on one stream, so the n-th kernel of the
    window is the n-th call's.  Returns {json of [q shape, k shape]:
    ``fa_wgmma<D>``'s own device ms per call}."""
    import torch
    from torch.profiler import ProfilerActivity

    from repro_torch.kernels import ops

    reps = 3
    firsts = {}
    for _, args, kw in calls:
        if args[0].dtype == torch.bfloat16:
            firsts.setdefault(json.dumps([list(args[0].shape), list(args[1].shape)]),
                              (args, kw))

    def run():
        for _ in range(reps):
            for a, k in firsts.values():
                ops.flash_attention(*a, **k)
        torch.cuda.synchronize()

    events = sorted((e for e in _profiled(run, [ProfilerActivity.CUDA]).events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    names = sorted({e.name for e in events})
    if any(FA_CUDA_CORE in n for n in names):
        raise AssertionError(f"served flash_attention calls ran {names}: {FA_CUDA_CORE} among "
                             "them")
    mine = [e for e in events if FA_TENSOR_CORE in e.name]
    if len(mine) != reps * len(firsts):
        raise AssertionError(f"{reps} × {len(firsts)} served flash_attention calls ran "
                             f"{len(mine)} {FA_TENSOR_CORE} kernels ({names})")
    own = {}
    for j, (shape, (args, kw)) in enumerate(firsts.items()):
        d = args[0].shape[-1]
        ran = mine[j::len(firsts)]
        if any(f"{FA_TENSOR_CORE}<{d}>" not in e.name for e in ran):
            raise AssertionError(f"a served flash_attention call at q, k {shape} ran "
                                 f"{[e.name for e in ran]}, not {FA_TENSOR_CORE}<{d}>")
        own[shape] = sum(e.time_range.elapsed_us() for e in ran) / reps / 1e3
        log(f"served flash_attention call (q, k {shape}, {args[0].dtype}) ran on the card as "
            f"{ran[0].name}; its own device time {own[shape]:.4f} ms a call")
    return own


def phase_queries(tables, frames, reps: int) -> None:
    """End-to-end latency of ``Frame.collect`` per query, sequential and
    with ``parallel=4`` in turns, and each run split into its compile
    (lowering, host only) and execute (operators, kernels and the copy of
    the result to the host) parts.  Every run compiles anew (no plan
    cache): this is a miss's latency; ``phase_plan_cache`` times hits."""
    import torch

    from repro_torch.frontends.dataflow import _to_numpy

    n_li = len(tables["lineitem"]["l_orderkey"])
    summary = {"sequential": {}, f"parallel{PARALLEL}": {}}
    for q, frame in frames.items():
        ctx = frame._ctx
        for par, mode in ((None, "sequential"), (PARALLEL, f"parallel{PARALLEL}")):
            frame.collect(device="cuda", parallel=par, cache=False)  # warm-up
            times, comp, run = [], [], []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                frame.collect(device="cuda", parallel=par, cache=False)
                t1 = time.perf_counter()
                compiled = ctx.compile(frame, parallel=par, device="cuda", cache=False)
                t2 = time.perf_counter()
                _to_numpy(compiled(ctx.sources("cuda"))[0])
                t3 = time.perf_counter()
                times.append((t1 - t0) * 1e3)
                comp.append((t2 - t1) * 1e3)
                run.append((t3 - t2) * 1e3)
            med = statistics.median(times)
            summary[mode][q] = {"median_ms": med, "min_ms": min(times), "max_ms": max(times),
                                "compile_ms": statistics.median(comp),
                                "execute_ms": statistics.median(run),
                                "lineitem_rows_per_s": n_li / (med / 1e3)}
            log(f"query {q} {mode}: median {med:.3f} ms over {reps} runs "
                f"(min {min(times):.3f}, max {max(times):.3f}; compile "
                f"{statistics.median(comp):.3f}, execute {statistics.median(run):.3f}); "
                f"{n_li / (med / 1e3):.4g} lineitem rows/s")
    log("queries: " + json.dumps(summary))


def report_kmeans(times) -> None:
    med = statistics.median(times)
    log(f"k-means step (FuseKMeansStep + Parallelize({KMEANS_PARALLEL}), n={KMEANS_N}): "
        f"median {med:.3f} ms over {len(times)} steps (min {min(times):.3f}, max "
        f"{max(times):.3f}); {KMEANS_N / (med / 1e3):.4g} points/s")
    log("kmeans: " + json.dumps({"median_ms": med, "min_ms": min(times),
                                 "max_ms": max(times), "steps": len(times),
                                 "points_per_s": KMEANS_N / (med / 1e3)}))


def report_serve(report) -> None:
    for mode in ("pallas", "ref", "chunked"):
        r = report[mode]
        log(f"serving {SERVE_ARCH} ({mode} attention): prefill {r['prefill_ms_per_wave']:.3f} ms "
            f"per wave of {SERVE_BATCH}×{SERVE_PROMPT} (median of {len(r['prefill_ms_all'])}), "
            f"{r['prefill_tokens_per_s']:.6g} prompt tokens/s; decode {r['decode_ms_per_step']:.3f} "
            f"ms per step of {SERVE_BATCH} tokens (min {r['decode_ms_min']:.3f}, max "
            f"{r['decode_ms_max']:.3f}); {r['tokens_per_s']:.6g} generated tokens/s over "
            f"{r['wall_s']:.3f} s; request latency p50 {r['latency_p50_s']:.4f} s, p99 "
            f"{r['latency_p99_s']:.4f} s")
    log("serve: " + json.dumps(report))


#: name fragments of this package's CUDA kernels in a profiler trace
OUR_KERNELS = ("fsa_gen", "grp_reg", "grp_scale", "grp_atomic", "grp_init", "grp_fix",
               "gja_gen_fill", "gja_gen_build", "kms_main", "kms_counts", "kms_tc", "fix_seg_",
               "seg_tc", "fa_main", "fa_wgmma")
#: the CUDA-core segsum's kernels (seg_main's route: fixsum.cuh's passes)
SEG_CUDA_CORE = "fix_seg_"
#: flash_attention's kernels: bf16 on the tensor cores, f32 on the CUDA cores
FA_TENSOR_CORE, FA_CUDA_CORE = "fa_wgmma", "fa_main"
#: kmeans_step's kernels: the path's shape on the tensor cores, others on the CUDA cores
KMS_TENSOR_CORE, KMS_CUDA_CORE = "kms_tc", "kms_main"


#: profiler windows a measurement may take: the first warms the profiler
#: up, and a window can come back with none of its device launches, so the
#: next one is taken
PROFILE_WINDOWS = 6
#: idle seconds inside each window before and after the work.  On the
#: H100's machine, once a process has been up for a minute or so (sooner
#: after spawned processes used the card), a window of a few ms loses all
#: of its device kernels about every other time, and 6 in a row can come
#: back empty; with 2 s on both sides 7 windows of 8 kept them, with 2 s
#: on one side 3 or 5 (tools/profiler_windows.py)
PROFILE_PAD_S = 2.0


def _profiled(fn, activities):
    """torch.profiler over ``fn()`` (which ends in a synchronise), padded
    with PROFILE_PAD_S idle seconds at both ends: the first window after
    the warm-up that recorded a device kernel (or the last one).  Windows
    that recorded none are logged."""
    from torch.profiler import profile

    empty = []
    for window in range(PROFILE_WINDOWS):
        with profile(activities=activities) as prof:
            time.sleep(PROFILE_PAD_S)
            fn()
            time.sleep(PROFILE_PAD_S)
        if _device_events(prof):
            if window:
                break
        else:
            empty.append(window)
    if empty:
        log(f"profiler: windows {empty} of {window + 1} recorded no device kernel")
    return prof


def device_ms_by_kernel(fn, reps: int = 3) -> dict:
    """{device kernel name: its own device ms per call of ``fn``} over
    ``reps`` calls, from torch.profiler after a warm-up window."""
    import torch
    from torch.profiler import ProfilerActivity

    def run():
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    out = {}
    for e in _device_events(_profiled(run, [ProfilerActivity.CUDA])):
        out[e.key] = out.get(e.key, 0.0) + e.self_device_time_total / 1e3 / reps
    return out


def device_kernels(fn, reps: int = 3):
    """The names of the device kernels that ``reps`` calls of ``fn``
    launch, from torch.profiler after a warm-up window."""
    return sorted(device_ms_by_kernel(fn, reps))


def _device_events(prof):
    import torch

    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and getattr(e, "self_device_time_total", 0) > 0]


def phase_profile(workloads, captured) -> None:
    """torch.profiler over each workload (after a profiled warm-up run):
    device time by kernel and the device's busy share of the traced span;
    then each path kernel call's own kernels alone."""
    import torch
    from torch.profiler import ProfilerActivity

    from repro_torch.kernels import ops

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for label, run in workloads.items():
        prof = _profiled(lambda: (run(), torch.cuda.synchronize()), acts)
        spans = [e.time_range for e in prof.events()]
        span_ms = (max(r.end for r in spans) - min(r.start for r in spans)) / 1e3
        events = _device_events(prof)
        dev_ms = sum(e.self_device_time_total for e in events) / 1e3
        ours = sum(e.self_device_time_total for e in events
                   if any(k in e.key for k in OUR_KERNELS)) / 1e3
        log(f"profile: {label}, traced span {span_ms:.3f} ms, device kernels "
            f"{dev_ms:.3f} ms (this package's CUDA kernels {ours:.3f} ms), "
            f"busy share {dev_ms / span_ms:.4f}")
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
        log(f"profile top ({label}): " + json.dumps([
            {"name": e.key[:70], "calls": e.count,
             "device_ms": e.self_device_time_total / 1e3} for e in top]))
    iters, rows = 10, []
    for i, (name, args, kw) in enumerate(captured):
        kern = getattr(ops, name)

        def calls():
            for _ in range(iters):
                kern(*args, **kw)
            torch.cuda.synchronize()

        prof = _profiled(calls, [ProfilerActivity.CUDA])
        # each wrapper call launches each of its kernels once: the mean per
        # recorded launch, summed over its kernels (the trace may lose some
        # of a window's launches, so dividing by iters would undercount)
        ours = [e for e in _device_events(prof) if any(k in e.key for k in OUR_KERNELS)]
        rows.append({"kernel": name, "call": i,
                     "kernel_device_ms": sum(e.self_device_time_total / e.count
                                             for e in ours) / 1e3,
                     "recorded": min((e.count for e in ours), default=0)})
    log(f"kernel device time (own launches only, mean per recorded launch of {iters}): "
        + json.dumps(rows))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _rel_gap(got, want) -> float:
    """‖got − want‖ / ‖want‖ of two tensors, in f64, on the card where
    either is there (on the host that takes seconds a billion elements)."""
    import torch
    from torch.linalg import vector_norm

    dev = got.device if got.is_cuda else want.device
    g, w = (t.detach().to(dev, torch.float64) for t in (got, want))
    return float(vector_norm(g - w) / max(float(vector_norm(w)), 1e-300))


def _grads_of(model, params, batch, microbatch: int = 1):
    """(loss, gradient tree) of one ``make_train_step`` call: its optimizer
    hands the gradients back as the new parameters."""
    from repro_torch.models.api import make_train_step
    from repro_torch.train.optimizer import Optimizer

    step, opt = make_train_step(model, Optimizer(lambda p: {}, lambda g, st, p: (g, st)),
                                microbatch=microbatch)
    grads, _, met = step(params, {}, batch)
    return met["loss"], grads


def _gap_report(what: str, got, want, loss_rtol: float, grad_rel: float,
                witness=None) -> dict:
    """Hold a (loss, gradient tree) against another: the loss to
    ``loss_rtol``, each leaf by ‖Δ‖/‖g‖ ≤ ``grad_rel``.  With a
    ``witness`` (the same computation as ``got`` in its dtype on the host)
    the loss and each leaf may also be up to WITNESS_FACTOR times the
    witness's own distance from ``want``: that much is the dtype's
    rounding, seen without the card."""
    from repro_torch.train.optimizer import tree_leaves

    (l1, g1), (l0, g0) = got, want
    loss_gap = abs(float(l1) - float(l0)) / abs(float(l0))
    gaps = [_rel_gap(a, b) for a, b in zip(tree_leaves(g1), tree_leaves(g0))]
    loss_bound, bounds, seen = loss_rtol, [grad_rel] * len(gaps), ""
    if witness is not None:
        lw, gw = witness
        w_loss = abs(float(lw) - float(l0)) / abs(float(l0))
        w_gaps = [_rel_gap(a, b) for a, b in zip(tree_leaves(gw), tree_leaves(g0))]
        loss_bound = max(loss_rtol, WITNESS_FACTOR * w_loss)
        bounds = [max(grad_rel, WITNESS_FACTOR * w) for w in w_gaps]
        seen = (f"; the host's own in the same dtype: loss rel {w_loss:.3g}, gradients' "
                f"largest {max(w_gaps):.3g}, so bounds of {loss_bound:.3g} and up to "
                f"{max(bounds):.3g} a leaf")
    log(f"train check {what}: loss {float(l1):.9g} against {float(l0):.9g} (rel "
        f"{loss_gap:.3g}, rtol {loss_rtol:g}); gradients' largest ‖Δ‖/‖g‖ over "
        f"{len(gaps)} leaves {max(gaps):.3g} (bound {grad_rel:g}){seen}")
    if not (loss_gap <= loss_bound and all(g <= b for g, b in zip(gaps, bounds))):  # NaN fails
        raise AssertionError(f"train check {what} failed: loss rel {loss_gap:.3g}, "
                             f"gradients {gaps} against bounds {bounds}")
    rep = {"loss_rel": loss_gap, "grad_rel_max": max(gaps)}
    if witness is not None:
        rep.update(witness_loss_rel=w_loss, witness_grad_rel_max=max(w_gaps),
                   grad_over_bound_max=max(g / b for g, b in zip(gaps, bounds)))
    return rep


def phase_train(smi: str, profile: bool) -> dict:
    """The training path (``models.api.make_train_step``: ``lm_loss`` with
    the chunked CE loss, autograd through ``chunked_attention`` with remat,
    AdamW) on the card: the refusal of the kernel under grad; full width at
    depth 2 against the same code in f64 on the host, remat and microbatch
    equalities; Qwen2-1.5B at full depth in bf16 for a warm-up and
    TRAIN_STEPS steps with the launch counts set to 0 just before and read
    just after (training launches none of the six kernels, as JAX's trainer
    launches no Pallas kernel); the launcher's bf16 resume."""
    import tempfile
    from dataclasses import replace

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import CheckpointManager
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.models.api import build_model, make_train_step, value_and_grad
    from repro_torch.train.optimizer import AdamW, tree_leaves, tree_map

    t_phase = time.perf_counter()
    report: dict = {"card": smi}
    # 1. the kernel is forward-only: under grad it refuses, on the card too
    q = torch.randn(1, 2, 64, 128, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    try:
        ops.attention(q, q, q, mode="pallas")
    except ValueError as e:
        log(f"train: attention(mode=\"pallas\") under grad refuses on the card: {e}")
    else:
        raise AssertionError("attention(mode='pallas') under grad did not refuse on the card")

    # 2. full width at depth 2: the card in f32 against the host in f64
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the f32 card check needs full-f32 products")
    base = get_config(SERVE_ARCH)
    cfg2 = replace(base, n_layers=TRAIN_CHECK_DEPTH, dtype="float32")
    model2 = build_model(cfg2)
    p2 = model2.init(torch.Generator("cuda").manual_seed(0))

    def batch_of(b, s, device):
        got = TokenPipeline(vocab=base.vocab, seq_len=s, global_batch=b, seed=0).batch_at(0)
        return {k: torch.from_numpy(v).to(device) for k, v in got.items()}

    t0 = time.perf_counter()
    card = _grads_of(model2, p2, batch_of(1, TRAIN_CHECK_S, "cuda"))
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = _grads_of(build_model(replace(cfg2, dtype="float64")),
                     tree_map(lambda t: t.detach().double().cpu(), p2),
                     batch_of(1, TRAIN_CHECK_S, "cpu"))
    t_host = time.perf_counter() - t0
    report["card_vs_host_f64"] = _gap_report(
        f"card f32 vs host f64 ({cfg2.n_layers} layers at full width, B=1, "
        f"S={TRAIN_CHECK_S}; card {t_card:.2f} s, host {t_host:.1f} s)",
        card, host, TRAIN_LOSS_RTOL, TRAIN_GRAD_REL)
    del host
    report["remat"] = _gap_report(
        "remat=False vs remat=True on the card",
        _grads_of(build_model(replace(cfg2, remat=False)), p2,
                  batch_of(1, TRAIN_CHECK_S, "cuda")),
        card, REMAT_RTOL, REMAT_RTOL)
    b2 = batch_of(2, TRAIN_CHECK_S, "cuda")
    report["microbatch"] = _gap_report(
        "microbatch=2 vs 1 on the card (B=2)", _grads_of(model2, p2, b2, microbatch=2),
        _grads_of(model2, p2, b2, microbatch=1), MICRO_LOSS_RTOL, MICRO_GRAD_REL)
    del card, p2, b2

    # 3. Qwen2-1.5B at full depth, bf16; memory is counted above what the
    # script already holds (earlier phases' tables, served parameters)
    held = torch.cuda.memory_allocated()
    model = build_model(base)
    t0 = time.perf_counter()
    params = model.init(torch.Generator("cuda").manual_seed(0))
    step, opt = make_train_step(model, AdamW(lr=TRAIN_LR), microbatch=1)
    state = opt.init(params)
    batch = batch_of(TRAIN_B, TRAIN_S, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    state_gb = sum(_bytes(t) for t in tree_leaves((params, state))) / 1e9
    log(f"training {base.arch}: {n_params / 1e9:.4f} B parameters ({base.dtype}), "
        f"parameters and AdamW state {state_gb:.3f} GB; B={TRAIN_B}, S={TRAIN_S}, "
        f"loss_chunk {base.loss_chunk}, remat {base.remat}, lr {TRAIN_LR}; set-up "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    params, state, met = step(params, state, batch)  # warm-up: the first step
    losses = [float(met["loss"])]
    warm_s = time.perf_counter() - t0
    times = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch)
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() - held
    if launches:
        raise AssertionError(f"the training path launched {launches}")
    log("train: the training path launched none of the six kernels (JAX's trainer runs "
        "chunked_attention in plain jnp and no Pallas kernel)")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses {losses}: not finite or not below the first")
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(params)):
        raise AssertionError("a parameter is not finite after training")
    # one more step in its two parts, each part's peak apart
    parts = {}

    def part_peak(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        got = fn()
        torch.cuda.synchronize()
        return got, (torch.cuda.max_memory_allocated() - held) / 1e9

    (_, grads), parts["loss and gradients"] = part_peak(
        lambda: value_and_grad(model.loss, params, batch))
    _, parts["AdamW update"] = part_peak(lambda: opt.update(grads, state, params))
    del grads, _
    step_s = statistics.median(times)
    tokens = TRAIN_B * TRAIN_S
    model_flops = 6 * base.n_params() * tokens
    report["qwen2_1_5b"] = {
        "losses": losses, "warmup_s": warm_s, "step_ms": [t * 1e3 for t in times],
        "step_ms_median": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "peak_allocated_gb": peak / 1e9, "peak_gb_by_part": parts,
        "held_by_earlier_phases_gb": held / 1e9, "model_flops": model_flops,
        "model_flops_share": model_flops / step_s / PEAK_BF16_TC}
    log(f"train ({smi}): {base.arch} {base.n_layers} layers bf16, B={TRAIN_B}×S={TRAIN_S}: "
        f"losses {[round(x, 4) for x in losses]}; step {step_s * 1e3:.1f} ms median of "
        f"{TRAIN_STEPS} (synchronised; warm-up {warm_s:.2f} s), {tokens / step_s:.0f} tokens/s, "
        f"peak allocated {peak / 1e9:.2f} GB above the {held / 1e9:.2f} GB earlier phases hold "
        f"({', '.join(f'{k} {v:.2f}' for k, v in parts.items())}), model-FLOPs share "
        f"{model_flops / step_s / PEAK_BF16_TC:.4f} (6·N·tokens = {model_flops:.4g} over "
        f"989 TFLOP/s dense bf16)")
    if profile:
        from torch.profiler import ProfilerActivity

        prof = _profiled(lambda: (step(params, state, batch), torch.cuda.synchronize()),
                         [ProfilerActivity.CPU, ProfilerActivity.CUDA])
        events = _device_events(prof)
        dev_ms = sum(e.self_device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:15]
        log(f"profile: one train step, device kernels {dev_ms:.3f} ms; top: " + json.dumps([
            {"name": e.key[:70], "calls": e.count,
             "device_ms": e.self_device_time_total / 1e3} for e in top]))
    del params, state, batch, met

    # 4. the launcher's resume in bf16, full width at depth 2
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--arch", base.arch, "--layers", str(TRAIN_CHECK_DEPTH), "--device", "cuda",
                  "--batch", str(TRAIN_B), "--seq", str(TRAIN_CHECK_S), "--lr", str(TRAIN_LR)]
        t0 = time.perf_counter()
        _, whole = train_mod.run(train_mod.parse_args(
            common + ["--steps", "6", "--ckpt-every", "100", "--ckpt-dir", f"{tmp}/whole"]))
        state3, first = train_mod.run(train_mod.parse_args(
            common + ["--steps", "3", "--ckpt-every", "3", "--ckpt-dir", f"{tmp}/cut"]))
        restored, extra = CheckpointManager(f"{tmp}/cut").restore(state3)
        for a, b in zip(tree_leaves(restored), tree_leaves(state3)):
            if a.dtype != b.dtype or a.device != b.device or not torch.equal(a, b):
                raise AssertionError(f"the step-3 restore differs from the saved state "
                                     f"({a.dtype} on {a.device} vs {b.dtype} on {b.device})")
        dtypes = sorted({str(t.dtype) for t in tree_leaves(restored)})
        del restored, state3
        _, rest = train_mod.run(train_mod.parse_args(
            common + ["--steps", "3", "--ckpt-every", "100", "--resume",
                      "--ckpt-dir", f"{tmp}/cut"]))
        gap = max(abs(a - b) / abs(b) for a, b in zip(first + rest, whole))
        if extra != {"step": 3} or gap > RESUME_LOSS_RTOL:
            raise AssertionError(f"resume: extra {extra}, losses {first + rest} against "
                                 f"{whole}")
        report["resume"] = {"losses": first + rest, "uninterrupted": whole, "max_rel_gap": gap}
        log(f"train resume: {base.arch} at {TRAIN_CHECK_DEPTH} layers, bf16: the step-3 "
            f"restore is the saved state bit for bit ({dtypes}); losses of 3 + 3 resumed "
            f"steps {[round(x, 5) for x in first + rest]} against the uninterrupted "
            f"{[round(x, 5) for x in whole]}, largest relative gap {gap:.3g} (rtol "
            f"{RESUME_LOSS_RTOL:g}); {time.perf_counter() - t0:.1f} s")
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"train phase took {report['phase_s']:.1f} s")
    return report


# ---------------------------------------------------------------------------
# the MoE and VLM families: Moonlight-16B-A3B served at full width and
# depth, Mixtral-8x7B's widths at a cut depth, Qwen2-VL-7B prefilled
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def routing(pin=None):
    """Record every ``layers.moe_route`` call (the router and dispatch of
    each MoE layer, in call order) as (probs (T, E), topi (T, K), pos
    (T·K,), keep (T·K,)), holding the tensors ``moe_block`` makes anyway,
    so no device work is added; ``first`` keeps the first call's input rows
    (T, D).  With ``pin`` (another run's record, call for call), each call
    takes that run's experts, places and kept choices, and weighs them by
    its own probabilities: the run then differs from the pinned one only
    by its arithmetic, not by a discrete routing decision."""
    import torch

    from repro_torch.models import layers

    original = layers.moe_route
    rec = {"calls": [], "first": None}

    def moe_route(p, xf, **kw):
        probs, topw, topi, pos, keep = original(p, xf, **kw)
        if rec["first"] is None:
            rec["first"] = xf
        if pin is not None:
            _, topi, pos, keep = pin[len(rec["calls"])]
            topw = probs.gather(1, topi)
            topw = topw / torch.sum(topw, dim=-1, keepdim=True)
        rec["calls"].append((probs, topi, pos, keep))
        return probs, topw, topi, pos, keep

    layers.moe_route = moe_route
    try:
        yield rec
    finally:
        layers.moe_route = original


def topk_margin(probs, k: int):
    """p_(k) − p_(k+1) per token: how far the k-th choice is from losing
    its place."""
    top = probs.topk(k + 1, dim=-1).values
    return top[:, k - 1] - top[:, k]


def routing_flips(label: str, got, want, fed, n_layers: int, top_k: int) -> dict:
    """(token, layer) routing flips of one serving run against the plain
    one, over every prefill token and the decode steps both runs were fed
    the same tokens (``fed``): a flip is a token whose set of top-k experts
    differs.  An expert leaves the top k only when another overtakes it,
    so a flip needs the plain run's margin p_(k) − p_(k+1) to be at most
    the sum of that token's two largest |Δp| between the runs; that is
    checked at every flip (a different routing rule, not rounding, would
    break it)."""
    import torch

    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} router calls against {len(want)}")
    per_wave = len(want) // len(fed)
    flips, compared, margins, per_layer = 0, 0, [], [0] * n_layers
    worst = 0.0
    for c, ((gp, gi, _, _), (wp, wi, _, _)) in enumerate(zip(got, want)):
        wave, rest = divmod(c, per_wave)
        step, layer = divmod(rest, n_layers)
        rows = torch.ones(gp.shape[0], dtype=torch.bool, device=gp.device)
        if step:  # a decode step: one token per request, only those fed the same
            rows = torch.tensor([step < n for n in fed[wave]], device=gp.device)
        diff = (gi.sort(-1).values != wi.sort(-1).values).any(-1) & rows
        compared += int(rows.sum())
        n = int(diff.sum())
        if not n:
            continue
        m = topk_margin(wp[diff], top_k)
        dp = (gp[diff] - wp[diff]).abs().topk(2, dim=-1).values.sum(-1)
        if not bool((m <= dp + 1e-6).all()):
            raise AssertionError(f"{label}: a routing flip at layer {layer}, step {step} where "
                                 f"the plain margin {m.max():.3g} exceeds the runs' |Δp|")
        worst = max(worst, float((m / dp.clamp(min=1e-30)).max()))
        flips += n
        per_layer[layer] += n
        margins += m.tolist()
    margins.sort()
    out = {"flips": flips, "tokens_compared": compared, "min_margin": margins[0] if margins
           else None, "max_margin": margins[-1] if margins else None,
           "median_margin": statistics.median(margins) if margins else None,
           "max_margin_over_dp": worst, "flips_per_layer": per_layer}
    log(f"routing {label}: {flips} (token, layer) flips of {compared} compared (prefill tokens "
        f"and decode steps fed the same tokens); plain top-{top_k} margin at a flip: min "
        f"{out['min_margin']}, median {out['median_margin']}, max {out['max_margin']} (each at "
        f"most the two runs' |Δp|: largest ratio {worst:.4f}); per layer {per_layer}")
    return out


def drop_shares(rec, n_layers: int, gen: int) -> list:
    """The share of (token, k) choices dropped per layer in prefill, over
    the run's waves."""
    per_wave = (1 + gen) * n_layers
    calls = rec["calls"]
    out = []
    for layer in range(n_layers):
        keeps = [calls[w + layer][3] for w in range(0, len(calls), per_wave)]
        out.append(float(1.0 - sum(float(k.float().mean()) for k in keeps) / len(keeps)))
    return out


def moe_bounds(cfg, params) -> dict:
    """The two floors of the code's work: a decode step reads every
    weight (the capacity dispatch runs all E experts on C = 4 slots) at
    3.35 TB/s; a prefill wave's expert products compute E·C slots of
    6·D·F operations per layer at 989 TFLOP/s."""
    from repro_torch.models import layers

    t = SERVE_BATCH * SERVE_PROMPT
    cap = layers.moe_capacity(t, cfg.top_k, cfg.n_experts, cfg.moe_capacity_factor)
    weight_bytes = sum(_bytes(x) for x in _leaves(params))
    flop = cfg.n_layers * cfg.n_experts * cap * 6 * cfg.d_model * cfg.d_ff
    return {"decode_weight_bytes": weight_bytes,
            "decode_floor_ms": weight_bytes / PEAK_BYTES * 1e3,
            "decode_capacity": layers.moe_capacity(SERVE_BATCH, cfg.top_k, cfg.n_experts,
                                                   cfg.moe_capacity_factor),
            "prefill_capacity": cap, "prefill_slots": cfg.n_experts * cap,
            "prefill_choices": t * cfg.top_k, "prefill_expert_flop": flop,
            "prefill_expert_floor_ms": flop / PEAK_BF16_TC * 1e3}


def check_moe_block(cfg, lp, x) -> dict:
    """``moe_block`` alone on the model's layer-0 input x (B, S, D) with
    layer 0's weights: bf16 twice, the same bits; then f32 against f64,
    both on the card (TF32 off): the routing may differ only where the f64
    top-k margin is at most MOE_F64_MARGIN, the agreeing tokens' outputs
    within ‖Δ‖ ≤ MOE_F32_REL·‖y‖, aux within MOE_F32_REL (plus what the
    first choices that moved shift it)."""
    import torch

    from repro_torch.models import layers

    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k, capacity_factor=cfg.moe_capacity_factor)
    t, d = x.shape[0] * x.shape[1], x.shape[2]
    cap = layers.moe_capacity(t, cfg.top_k, cfg.n_experts, cfg.moe_capacity_factor)
    (y1, a1), (y2, a2) = layers.moe_block(lp, x, **kw), layers.moe_block(lp, x, **kw)
    if not (torch.equal(y1.view(torch.int16), y2.view(torch.int16))
            and torch.equal(a1.view(torch.int32), a2.view(torch.int32))):
        raise AssertionError("moe_block: two bf16 runs on the card give different bits")
    ms = cuda_ms(lambda: layers.moe_block(lp, x, **kw), iters=5)
    flop = cfg.n_experts * cap * 6 * d * cfg.d_ff
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the f32 moe_block check needs full-f32 products")
    out = {}
    for dt in (torch.float32, torch.float64):
        p = {k: v.to(dt) for k, v in lp.items()}
        xd = x.to(dt)
        y, aux = layers.moe_block(p, xd, **kw)
        route = layers.moe_route(p, xd.reshape(t, d), n_experts=cfg.n_experts,
                                 top_k=cfg.top_k, capacity=cap)
        out[dt] = (y.reshape(t, d), aux, route)
        del p
    (y32, a32, r32), (y64, a64, r64) = out[torch.float32], out[torch.float64]
    same = (r32[2].sort(-1).values == r64[2].sort(-1).values).all(-1)
    margin = topk_margin(r64[0], cfg.top_k)
    flips = int((~same).sum())
    if flips and not bool((margin[~same] <= MOE_F64_MARGIN).all()):
        raise AssertionError(f"moe_block f32 vs f64: a routing flip at an f64 margin of "
                             f"{float(margin[~same].max())}, over {MOE_F64_MARGIN}")
    k32 = r32[4].view(t, -1).gather(1, r32[2].sort(-1).indices)
    k64 = r64[4].view(t, -1).gather(1, r64[2].sort(-1).indices)
    agree = same & (k32 == k64).all(-1)
    a, b = y32[agree].double(), y64[agree]
    rel = float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
    first = int((r32[2][:, 0] != r64[2][:, 0]).sum())
    aux_bound = MOE_F32_REL * abs(float(a64)) + 2 * cfg.n_experts * first / t * float(
        r64[0].mean(0).max())
    if rel > MOE_F32_REL or abs(float(a32) - float(a64)) > aux_bound:
        raise AssertionError(f"moe_block f32 vs f64: ‖Δ‖/‖y‖ {rel} over {int(agree.sum())} "
                             f"agreeing tokens, aux {float(a32)} vs {float(a64)}")
    report = {"bf16_same_bits_twice": True, "bf16_ms": ms, "expert_flop": flop,
              "expert_floor_ms": flop / PEAK_BF16_TC * 1e3, "tokens": t, "capacity": cap,
              "f64_flips": flips, "f64_min_margin": float(margin.min()),
              "agreeing_tokens": int(agree.sum()), "f32_rel": rel,
              "f32_max_abs": float((a - b).abs().max()), "y_max": float(b.abs().max()),
              "aux_f32": float(a32), "aux_f64": float(a64),
              "dropped_share": float(1 - r64[4].double().mean())}
    log(f"moe_block alone ({cfg.arch} layer 0, T={t}, C={cap}): bf16 twice on the card, the "
        f"same bits; {ms:.3f} ms (expert products {flop:.4g} FLOP, floor "
        f"{report['expert_floor_ms']:.3f} ms at 989 TFLOP/s); f32 vs f64 on the card: "
        f"{flips} routing flips (allowed at f64 margins ≤ {MOE_F64_MARGIN:g}; smallest f64 "
        f"margin {report['f64_min_margin']:.3g}), {int(agree.sum())} of {t} tokens agree, "
        f"‖Δ‖/‖y‖ {rel:.3g} (≤ {MOE_F32_REL:g}), max |Δ| {report['f32_max_abs']:.3g} of "
        f"max |y| {report['y_max']:.4g}; aux {float(a32):.9g} vs {float(a64):.9g}; dropped "
        f"{report['dropped_share']:.4f} of the choices")
    return report


def image_then_text(b: int, s: int, grid: int):
    """positions3 (3, B, S) as numpy: a grid × grid patch image (t = 0,
    h = row, w = col), then text whose three streams continue together from
    the grid's largest position + 1."""
    import numpy as np

    pos = np.zeros((3, b, s), np.int32)
    n = min(grid * grid, s)
    idx = np.arange(n)
    pos[1, :, :n] = idx // grid
    pos[2, :, :n] = idx % grid
    pos[:, :, n:] = np.arange(s - n, dtype=np.int32) + grid
    return pos


def prefill_decode(model, params, batch, gen: int):
    """``model.prefill`` on ``batch`` (a cache of SERVE_CAP), then ``gen``
    greedy decode steps: ({row: tokens}, [[the logits of each call]],
    prefill s, decode s per step), the card synchronised around the
    prefill and each step's tokens read back."""
    import numpy as np
    import torch

    from repro_torch.models.api import make_serve_step

    serve = make_serve_step(model)
    dec = []
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, SERVE_CAP)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        pre = time.perf_counter() - t0
        calls, toks = [logits], []
        for _ in range(gen):
            t0 = time.perf_counter()
            tok, logits, cache = serve(params, cache, tok)
            toks.append(tok[:, 0].cpu().numpy())
            dec.append(time.perf_counter() - t0)
            calls.append(logits)
    toks = np.stack(toks, 1)
    return {j: toks[j] for j in range(toks.shape[0])}, [calls], pre, dec


def serve_from_empty(arch: str, model, params, rng) -> dict:
    """``serve_loop`` through ``make_run_wave``'s else branch (the vlm,
    hybrid and rwkv families, as JAX's launcher): SERVE_REQUESTS requests
    of SERVE_PROMPT tokens from ``rng``, each wave from ``init_state``'s
    empty state with a zero token and no prefill, so no kernel launches
    and every request gets the same tokens.  Returns the serving numbers."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Request

    prompts = rng.integers(0, model.cfg.vocab, (SERVE_REQUESTS, SERVE_PROMPT))
    ops.reset_launches()
    served, slog, tracer, wall = _serve_once(
        model, params, [Request(rid=i, prompt=prompts[i]) for i in range(SERVE_REQUESTS)])
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"{arch} serve: launched {dict(ops.LAUNCHES)} with no prefill")
    if sorted(served) != list(range(SERVE_REQUESTS)):
        raise AssertionError(f"{arch} serve: served {sorted(served)}")
    if any(not np.array_equal(t, served[0]) for t in served.values()):
        raise AssertionError(f"{arch} serve: requests decoded from the same empty state "
                             "and zero token differ")
    if not all(bool(torch.isfinite(x).all()) for w in slog for x in w):
        raise AssertionError(f"{arch} serve: non-finite logits")
    return _serve_numbers(tracer, wall, len(served))


def phase_vlm(smi: str):
    """Qwen2-VL-7B at full width and depth: ``model.prefill`` on B × S
    seeded stub embeddings with an image-then-text ``positions3``, then
    VLM_GEN greedy decode steps from that cache (JAX's 1-D RoPE decode);
    pallas (counted: flash_attention once per layer), the plain path, f64
    attention (the noise floor) and chunked, held to the plain path by phase
    18's rule; then ``serve_loop`` through ``make_run_wave``'s vlm branch,
    which decodes from an empty cache.  Returns (launches, the recorded
    kernel calls, the report)."""
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    base = get_config(VLM_ARCH)
    t0 = time.perf_counter()
    model = build_model(replace(base, attn_mode="pallas"))
    params = model.init(torch.Generator("cuda").manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(0)
    embeds = torch.from_numpy(rng.normal(size=(SERVE_BATCH, SERVE_PROMPT, base.d_model))
                              .astype(np.float32)).cuda()
    pos3 = torch.from_numpy(image_then_text(SERVE_BATCH, SERVE_PROMPT, VLM_GRID)).cuda()
    batch = {"embeds": embeds, "positions3": pos3}
    torch.cuda.synchronize()
    log(f"{VLM_ARCH}: {n_params / 1e9:.4f} B parameters ({base.dtype}, "
        f"{sum(_bytes(t) for t in _leaves(params)) / 1e9:.3f} GB; {held / 1e9:.2f} GB held by "
        f"earlier phases); M-RoPE sections {base.mrope_sections}; B={SERVE_BATCH} × "
        f"S={SERVE_PROMPT} stub embeddings, a {VLM_GRID}×{VLM_GRID} image then "
        f"{SERVE_PROMPT - VLM_GRID * VLM_GRID} text positions; set-up "
        f"{time.perf_counter() - t0:.1f} s")

    def run(m):
        return prefill_decode(m, params, batch, VLM_GEN)

    with torch.inference_mode():
        model.prefill(params, batch, SERVE_CAP)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    n_l = base.n_layers
    with recording(("flash_attention",), keep=lambda i: i in (0, n_l - 1)) as captured:
        ops.reset_launches()
        out, logits, pre, dec = run(model)
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() - held
    if launches != {"flash_attention": n_l}:
        raise AssertionError(f"{VLM_ARCH}: launched {launches}, not flash_attention {n_l}")
    if not all(bool(torch.isfinite(x).all()) for x in logits[0]):
        raise AssertionError(f"{VLM_ARCH}: non-finite logits")
    for toks in out.values():
        if not ((toks >= 0) & (toks < base.vocab)).all():
            raise AssertionError(f"{VLM_ARCH}: tokens {toks}")
    flop = 2 * n_params * SERVE_BATCH * SERVE_PROMPT
    report = {"card": smi, "pallas": {"prefill_ms": pre * 1e3,
                                      "decode_ms_per_step": statistics.median(dec) * 1e3,
                                      "prefill_model_flop": flop,
                                      "prefill_flop_share": flop / pre / PEAK_BF16_TC},
              "peak_allocated_gb": peak / 1e9, "held_gb": held / 1e9, "n_params": n_params}
    runs = {"pallas": (out, logits)}
    for name, mode in (("ref", "ref"), ("exact", exact_attention), ("chunked", "chunked")):
        o, lg, p_s, d_s = run(build_model(replace(base, attn_mode=mode)))
        runs[name] = (o, lg)
        if name != "exact":
            report[name] = {"prefill_ms": p_s * 1e3,
                            "decode_ms_per_step": statistics.median(d_s) * 1e3}
    _, noise, same, std = path_gap(runs["ref"][1], runs["exact"][1])
    report["noise_floor"] = {"max_abs": noise, "same_token_steps": same, "logit_std": std}
    log(f"{VLM_ARCH} noise floor: the plain path's logits differ from those with exactly "
        f"rounded (f64) prefill attention by up to {noise:.6g} ({noise / std:.4f} of their "
        f"std {std:.6g}) over the {same} steps fed the same tokens")
    for name in ("pallas", "chunked"):
        report[f"{name}_vs_ref"] = compare_paths(f"{VLM_ARCH} {name} vs ref", runs[name],
                                                 runs["ref"], runs["exact"][1], noise, VLM_GEN)
    del runs, logits
    # the serve loop's vlm branch: no prefill, an empty cache and a zero token
    report["serve_from_empty"] = serve_from_empty(VLM_ARCH, model, params, rng)
    r, s_ = report["pallas"], report["serve_from_empty"]
    log(f"{VLM_ARCH} ({smi}): prefill {r['prefill_ms']:.3f} ms for {SERVE_BATCH}×{SERVE_PROMPT} "
        f"(model FLOPs 2·N·tokens {flop:.4g}, share {r['prefill_flop_share']:.4f} of 989 "
        f"TFLOP/s; ref {report['ref']['prefill_ms']:.3f}, chunked "
        f"{report['chunked']['prefill_ms']:.3f}); decode {r['decode_ms_per_step']:.3f} ms per "
        f"step from that cache; peak {peak / 1e9:.3f} GB above the {held / 1e9:.2f} GB held; "
        f"serve_loop (vlm branch, decode from an empty cache): {SERVE_REQUESTS} requests, decode "
        f"{s_['decode_ms_per_step']:.3f} ms per step, {s_['tokens_per_s']:.6g} tokens/s, "
        f"latency p50 {s_['latency_p50_s']:.4f} s, p99 {s_['latency_p99_s']:.4f} s; every "
        f"request the same {SERVE_GEN} tokens")
    del params, model, embeds, batch
    report["phase_s"] = time.perf_counter() - t_phase
    log("vlm: " + json.dumps(report))
    log(f"vlm phase took {report['phase_s']:.1f} s")
    return launches["flash_attention"], list(captured), report


def ssd_flop(b: int, s: int, h: int, p: int, n: int, c: int) -> int:
    """The operations ``ssd_chunked`` does on (B, S, H, P) inputs with N
    states in chunks of c: the scores (C·Bᵀ), their decay weights, the
    intra-chunk product, the chunk states, the inter-chunk product and its
    decay."""
    return (2 * b * s * c * n + b * s * c * h + 2 * b * s * c * h * p
            + b * s * n * h + 2 * b * s * h * n * p + 2 * b * s * n * h * p + b * s * h * p)


def check_ssd(cfg) -> dict:
    """``ssd_chunked`` alone at a prefill layer's shapes (B = SERVE_BATCH,
    S = SERVE_PROMPT, H = d_inner / 64, P = 64, N = ssm_state, the config's
    chunk) on seeded inputs (x, B, C normal, the log-decay −softplus of a
    normal, as ``mamba2_block`` makes it with A = −1): the f32 math on the
    card against the same inputs in f64 on the card, ‖Δ‖ ≤ SSD_REL·‖y‖ for
    the output and the final state; timed with x, B and C in bf16 (as the
    path gives them) and in f32, beside its floor (operations at the f32
    rate: the einsums are f32 products)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import ssm

    b, s, h, p, n, c = (SERVE_BATCH, SERVE_PROMPT, cfg.d_inner // ssm.MAMBA_HEAD,
                        ssm.MAMBA_HEAD, cfg.ssm_state, cfg.ssm_chunk)
    gen = torch.Generator("cuda").manual_seed(1)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x, a = normal(b, s, h, p), -F.softplus(normal(b, s, h))
    bm, cm = normal(b, s, n), normal(b, s, n)
    y32, s32 = ssm.ssd_chunked(x, a, bm, cm, chunk=c)
    y64, s64 = ssm.ssd_chunked(x.double(), a.double(), bm.double(), cm.double(), chunk=c)
    gaps = {k: float(torch.linalg.vector_norm(g.double() - w) / torch.linalg.vector_norm(w))
            for k, g, w in (("y", y32, y64), ("state", s32, s64))}
    if not all(g <= SSD_REL for g in gaps.values()):
        raise AssertionError(f"ssd_chunked f32 vs f64 on the card: ‖Δ‖/‖y‖ {gaps} over "
                             f"{SSD_REL}")
    del y64, s64
    x16, b16, c16 = x.bfloat16(), bm.bfloat16(), cm.bfloat16()
    flop = ssd_flop(b, s, h, p, n, c)
    out = {"shape": [b, s, h, p, n, c], "rel_err_vs_f64": gaps,
           "ms_bf16_inputs": cuda_ms(lambda: ssm.ssd_chunked(x16, a, b16, c16, chunk=c)),
           "ms_f32": cuda_ms(lambda: ssm.ssd_chunked(x, a, bm, cm, chunk=c)),
           "flop": flop, "floor_ms": flop / PEAK_F32 * 1e3}
    log(f"ssd_chunked alone at {out['shape']} (B, S, H, P, N, chunk): f32 vs f64 on the card "
        f"‖Δ‖/‖y‖ {gaps['y']:.3g}, state {gaps['state']:.3g} (limit {SSD_REL}); "
        f"{out['ms_bf16_inputs']:.3f} ms with bf16 inputs, {out['ms_f32']:.3f} ms f32, floor "
        f"{out['floor_ms']:.3f} ms ({flop / 1e9:.4g} GFLOP at 67 TFLOP/s)")
    return out


def fa_width_rates(args, kw) -> dict:
    """flash_attention at the served D = 112 call's shape against the same
    shape at D = 128 (seeded inputs), each timed with CUDA events: ms a
    launch and achieved TFLOP/s by the unmasked work (4·B·Hq·D per kept
    pair), so the zero-filled tile's cost shows beside D = 128's rate."""
    import torch

    from repro_torch.kernels import ops

    q, k, v = args
    b, hq, s, _ = q.shape
    gen = torch.Generator("cuda").manual_seed(2)
    out = {}
    for d in (q.shape[-1], 128):
        qkv = (q, k, v) if d == q.shape[-1] else tuple(
            torch.randn((b, t.shape[1], s, d), generator=gen, device="cuda").to(q.dtype)
            for t in (q, k, v))
        ms = cuda_ms(lambda: ops.flash_attention(*qkv, **kw))
        flop = 4 * b * hq * d * attention_pairs(s, kw)
        out[f"d{d}"] = {"ms": ms, "tflop_per_s": flop / ms / 1e9,
                        "bound_ms": flop / PEAK_BF16_TC * 1e3}
    log(f"flash_attention at {tuple(q.shape)} {q.dtype}: D = {q.shape[-1]} "
        f"{out[f'd{q.shape[-1]}']}; the same shape at D = 128 {out['d128']}")
    return out


def phase_zamba2(smi: str):
    """Zamba2-7B at full width and ZAMBA_SERVE_LAYERS layers: ``model.prefill``
    on SERVE_BATCH × SERVE_PROMPT numpy-seeded tokens, then ZAMBA_GEN greedy
    decode steps from that state; pallas (counted: flash_attention once per
    attention point, 7, at D = 112), the plain path, f64 attention (the noise floor) and
    chunked, held to the plain path by phase 18's rule; ``ssd_chunked``
    alone (``check_ssd``); then ``serve_loop`` through ``make_run_wave``'s
    hybrid branch, which decodes from an empty state.  Returns (launches,
    the recorded kernel calls, the report)."""
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    base = replace(get_config(ZAMBA_ARCH), n_layers=ZAMBA_SERVE_LAYERS)
    t0 = time.perf_counter()
    model = build_model(replace(base, attn_mode="pallas"))
    params = model.init(torch.Generator("cuda").manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    weight_bytes = sum(_bytes(t) for t in _leaves(params))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, base.vocab, (SERVE_BATCH, SERVE_PROMPT))
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    torch.cuda.synchronize()
    points = base.n_attn_points
    log(f"{ZAMBA_ARCH}: {n_params / 1e9:.4f} B parameters (ModelConfig.n_params() "
        f"{base.n_params()}; {base.dtype}, {weight_bytes / 1e9:.3f} GB; {held / 1e9:.2f} GB held "
        f"by earlier phases); {base.n_layers} Mamba2 layers, the shared attention at {points} "
        f"points (d_head {base.d_head}); B={SERVE_BATCH} × S={SERVE_PROMPT} tokens; set-up "
        f"{time.perf_counter() - t0:.1f} s")

    def run(m):
        return prefill_decode(m, params, batch, ZAMBA_GEN)

    with torch.inference_mode():
        model.prefill(params, batch, SERVE_CAP)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    with recording(("flash_attention",), keep=lambda i: i in (0, points - 1)) as captured:
        ops.reset_launches()
        out, logits, pre, dec = run(model)
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() - held
    if launches != {"flash_attention": points}:
        raise AssertionError(f"{ZAMBA_ARCH}: launched {launches}, not flash_attention {points}")
    want = (SERVE_BATCH, base.n_heads, SERVE_PROMPT, base.d_head)
    if any(tuple(c[1][0].shape) != want or c[1][0].dtype != torch.bfloat16 for c in captured):
        raise AssertionError(f"{ZAMBA_ARCH}: flash_attention calls "
                             f"{[tuple(c[1][0].shape) for c in captured]}, not {want} bf16")
    if not all(bool(torch.isfinite(x).all()) for x in logits[0]):
        raise AssertionError(f"{ZAMBA_ARCH}: non-finite logits")
    for toks in out.values():
        if not ((toks >= 0) & (toks < base.vocab)).all():
            raise AssertionError(f"{ZAMBA_ARCH}: tokens {toks}")
    # floors: prefill 2·N·tokens on the tensor cores plus the SSD's f32
    # einsums; decode reads every weight and the whole state once a step
    h = base.d_inner // 64
    state_bytes = (base.n_layers * SERVE_BATCH * (3 * base.d_inner * 2
                                                  + h * base.ssm_state * 64 * 4)
                   + 2 * points * SERVE_BATCH * base.n_kv_heads * SERVE_CAP * base.d_head * 2)
    flop = 2 * n_params * SERVE_BATCH * SERVE_PROMPT
    ssd = base.n_layers * ssd_flop(SERVE_BATCH, SERVE_PROMPT, h, 64, base.ssm_state,
                                   base.ssm_chunk)
    floors = {"prefill_model_flop": flop, "prefill_ssd_flop": ssd,
              "prefill_floor_ms": (flop / PEAK_BF16_TC + ssd / PEAK_F32) * 1e3,
              "decode_bytes": weight_bytes + state_bytes,
              "decode_floor_ms": (weight_bytes + state_bytes) / PEAK_BYTES * 1e3}
    report = {"card": smi, "pallas": {"prefill_ms": pre * 1e3,
                                      "decode_ms_per_step": statistics.median(dec) * 1e3,
                                      "decode_ms_all": [x * 1e3 for x in dec],
                                      "prefill_flop_share": flop / pre / PEAK_BF16_TC},
              "floors": floors, "peak_allocated_gb": peak / 1e9, "held_gb": held / 1e9,
              "n_params": n_params, "weight_gb": weight_bytes / 1e9,
              "state_gb": state_bytes / 1e9}
    runs = {"pallas": (out, logits)}
    for name, mode in (("ref", "ref"), ("exact", exact_attention), ("chunked", "chunked")):
        o, lg, p_s, d_s = run(build_model(replace(base, attn_mode=mode)))
        runs[name] = (o, lg)
        if name != "exact":
            report[name] = {"prefill_ms": p_s * 1e3,
                            "decode_ms_per_step": statistics.median(d_s) * 1e3}
    _, noise, same, std = path_gap(runs["ref"][1], runs["exact"][1])
    report["noise_floor"] = {"max_abs": noise, "same_token_steps": same, "logit_std": std}
    log(f"{ZAMBA_ARCH} noise floor: the plain path's logits differ from those with exactly "
        f"rounded (f64) prefill attention by up to {noise:.6g} ({noise / std:.4f} of their "
        f"std {std:.6g}) over the {same} steps fed the same tokens")
    for name in ("pallas", "chunked"):
        report[f"{name}_vs_ref"] = compare_paths(f"{ZAMBA_ARCH} {name} vs ref", runs[name],
                                                 runs["ref"], runs["exact"][1], noise, ZAMBA_GEN)
    del runs, logits
    report["flash_attention_widths"] = fa_width_rates(*captured[0][1:])
    report["ssd_chunked"] = check_ssd(base)
    # the serve loop's hybrid branch: no prefill, an empty state and a zero token
    report["serve_from_empty"] = serve_from_empty(ZAMBA_ARCH, model, params, rng)
    r, s_ = report["pallas"], report["serve_from_empty"]
    log(f"{ZAMBA_ARCH} ({smi}): prefill {r['prefill_ms']:.3f} ms for {SERVE_BATCH}×"
        f"{SERVE_PROMPT} (floor {floors['prefill_floor_ms']:.3f} ms: 2·N·tokens {flop:.4g} at "
        f"989 TFLOP/s plus the SSD's {ssd:.4g} f32 at 67; ref {report['ref']['prefill_ms']:.3f}, "
        f"chunked {report['chunked']['prefill_ms']:.3f}); decode {r['decode_ms_per_step']:.3f} "
        f"ms per step from that state (floor {floors['decode_floor_ms']:.3f} ms: "
        f"{weight_bytes / 1e9:.2f} GB of weights and {state_bytes / 1e9:.2f} GB of SSM and KV "
        f"state at 3.35 TB/s); {SERVE_BATCH * ZAMBA_GEN / sum(dec):.6g} generated tokens/s; "
        f"peak {peak / 1e9:.3f} GB above the {held / 1e9:.2f} GB held; serve_loop (hybrid "
        f"branch, decode from an empty state): {SERVE_REQUESTS} requests, decode "
        f"{s_['decode_ms_per_step']:.3f} ms per step, {s_['tokens_per_s']:.6g} tokens/s, "
        f"latency p50 {s_['latency_p50_s']:.4f} s, p99 {s_['latency_p99_s']:.4f} s; every "
        f"request the same {SERVE_GEN} tokens")
    del params, model, batch
    report["phase_s"] = time.perf_counter() - t_phase
    log("hybrid: " + json.dumps(report))
    log(f"hybrid phase took {report['phase_s']:.1f} s")
    return launches["flash_attention"], list(captured), report


def phase_rwkv(smi: str):
    """RWKV6-1.6B at full width and depth: ``model.prefill`` on SERVE_BATCH ×
    RWKV_PROMPT numpy-seeded tokens, then RWKV_GEN greedy decode steps
    (no kernel: RWKV has no attention); the same weights in f32 and in f64
    on the card, the f32 run's logits within RWKV_F32_REL of the f64
    logits' largest magnitude and the bf16 run's within an RMS distance of
    RWKV_BF16_RMS of their std (over the steps fed the same tokens); in
    f32, decode after a prefill of S − 1 tokens against the prefill of S
    (``tests/test_models_smoke.py``'s 2e-3); then ``serve_loop`` through
    ``make_run_wave``'s rwkv branch.  The time scan is a loop over S ×
    layers steps, each a few small launches: prefill ms per (position,
    layer) is its host cost.  Returns (0, [],
    the report)."""
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.train.optimizer import tree_map

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    base = get_config(RWKV_ARCH)
    t0 = time.perf_counter()
    model = build_model(base)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    weight_bytes = sum(_bytes(t) for t in _leaves(params))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, base.vocab, (SERVE_BATCH, RWKV_PROMPT))).cuda()
    batch = {"tokens": tokens}
    torch.cuda.synchronize()
    log(f"{RWKV_ARCH}: {n_params / 1e9:.4f} B parameters (ModelConfig.n_params() "
        f"{base.n_params()}; {base.dtype}, {weight_bytes / 1e9:.3f} GB; {held / 1e9:.2f} GB held "
        f"by earlier phases); B={SERVE_BATCH} × S={RWKV_PROMPT} tokens; set-up "
        f"{time.perf_counter() - t0:.1f} s")
    with torch.inference_mode():
        model.prefill(params, {"tokens": tokens[:, :16]}, SERVE_CAP)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out, logits, pre, dec = prefill_decode(model, params, batch, RWKV_GEN)
    if any(ops.LAUNCHES.values()):
        raise AssertionError(f"{RWKV_ARCH}: launched {dict(ops.LAUNCHES)}; RWKV runs no kernel")
    peak = torch.cuda.max_memory_allocated() - held
    if not all(bool(torch.isfinite(x).all()) for x in logits[0]):
        raise AssertionError(f"{RWKV_ARCH}: non-finite logits")
    for toks in out.values():
        if not ((toks >= 0) & (toks < base.vocab)).all():
            raise AssertionError(f"{RWKV_ARCH}: tokens {toks}")
    steps = RWKV_PROMPT * base.n_layers
    flop = 2 * n_params * SERVE_BATCH * RWKV_PROMPT
    report = {"card": smi, "prompt": RWKV_PROMPT,
              "bf16": {"prefill_ms": pre * 1e3,
                       "decode_ms_per_step": statistics.median(dec) * 1e3,
                       "decode_ms_all": [x * 1e3 for x in dec],
                       "prefill_us_per_scan_step": pre * 1e6 / steps,
                       "prefill_floor_ms": flop / PEAK_BF16_TC * 1e3,
                       "decode_floor_ms": weight_bytes / PEAK_BYTES * 1e3},
              "peak_allocated_gb": peak / 1e9, "held_gb": held / 1e9, "n_params": n_params}
    runs = {"bf16": (out, logits)}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        m = build_model(replace(base, dtype=str(dtype)[6:]))
        o, lg, p_s, d_s = prefill_decode(m, tree_map(lambda t: t.to(dtype), params), batch,
                                         RWKV_GEN)
        runs[name] = (o, lg)
        report[name] = {"prefill_ms": p_s * 1e3,
                        "decode_ms_per_step": statistics.median(d_s) * 1e3}
    f64 = runs["f64"][1]
    top = float(torch.stack([x.abs().max() for w in f64 for x in w]).max())
    for name in ("f32", "bf16"):
        pre_gap, worst, same, std = path_gap(runs[name][1], f64)
        rms = logit_rms_gap(runs[name][1], f64)
        got, limit = (worst, RWKV_F32_REL * top) if name == "f32" else (rms, RWKV_BF16_RMS * std)
        report[f"{name}_vs_f64"] = {"prefill_max_abs": pre_gap, "max_abs": worst, "rms": rms,
                                    "same_token_steps": same, "logit_std": std,
                                    "limit": limit, "f64_max_abs": top}
        log(f"{RWKV_ARCH} {name} vs f64 on the card: logits max |Δ| {worst:.6g}, RMS {rms:.6g} "
            f"over {same} steps fed the same tokens (prefill max {pre_gap:.6g}; std {std:.6g}, "
            f"f64 max |logit| {top:.6g}); held: {'max' if name == 'f32' else 'RMS'} ≤ "
            f"{limit:.6g}")
        if not got <= limit:
            raise AssertionError(f"{RWKV_ARCH} {name} vs f64: logits differ by {got} over "
                                 f"{limit}")
    # decode after a prefill of S − 1 tokens against the prefill of S, in f32
    m32 = build_model(replace(base, dtype="float32"))
    p32 = tree_map(lambda t: t.float(), params)
    with torch.inference_mode():
        _, st = m32.prefill(p32, {"tokens": tokens[:, :-1]}, SERVE_CAP)
        got, _ = m32.decode(p32, st, tokens[:, -1:].to(torch.int32))
    want = runs["f32"][1][0][0]
    gap = float((got - want).abs().max())
    report["decode_vs_longer_prefill"] = {"max_abs": gap, "want_max_abs": float(want.abs().max())}
    if not bool(((got - want).abs() <= 2e-3 + 2e-3 * want.abs()).all()):
        raise AssertionError(f"{RWKV_ARCH}: decode after S − 1 differs from the prefill of S by "
                             f"{gap}")
    del runs, logits, p32, m32, st
    report["serve_from_empty"] = serve_from_empty(RWKV_ARCH, model, params, rng)
    r, s_ = report["bf16"], report["serve_from_empty"]
    log(f"{RWKV_ARCH} ({smi}): prefill {r['prefill_ms']:.3f} ms for {SERVE_BATCH}×{RWKV_PROMPT} "
        f"({r['prefill_us_per_scan_step']:.2f} µs per (position, layer) of the time scan; floor "
        f"{r['prefill_floor_ms']:.3f} ms for 2·N·tokens at 989 TFLOP/s); decode "
        f"{r['decode_ms_per_step']:.3f} ms per step (floor {r['decode_floor_ms']:.3f} ms for "
        f"{weight_bytes / 1e9:.2f} GB of weights); decode after S − 1 vs the prefill of S (f32) "
        f"max |Δ| {gap:.3g}; peak {peak / 1e9:.3f} GB above the {held / 1e9:.2f} GB held; "
        f"serve_loop (rwkv branch, decode from an empty state): {SERVE_REQUESTS} requests, decode "
        f"{s_['decode_ms_per_step']:.3f} ms per step, {s_['tokens_per_s']:.6g} tokens/s, every "
        f"request the same {SERVE_GEN} tokens")
    del params, model, batch
    report["phase_s"] = time.perf_counter() - t_phase
    log("rwkv: " + json.dumps(report))
    log(f"rwkv phase took {report['phase_s']:.1f} s")
    return 0, [], report


# ---------------------------------------------------------------------------
# the enc-dec family: Whisper-base served and trained at full width and depth
# ---------------------------------------------------------------------------


def whisper_serve(model, params, gen: int = WHISPER_GEN):
    """``serve_loop`` over WHISPER_REQUESTS requests through
    ``make_run_wave``'s encdec branch, as ``launch/serve.py``'s main draws
    them: the prompts (WHISPER_FRAMES tokens, not read) from
    ``np.random.default_rng(0)``, then each wave's stub frames (WHISPER_BATCH,
    WHISPER_FRAMES, d_model) from the same generator; ``_serve_once``'s
    return."""
    import numpy as np

    from repro_torch.launch.serve import Request

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, model.cfg.vocab, (WHISPER_REQUESTS, WHISPER_FRAMES))
    return _serve_once(model, params, [Request(rid=i, prompt=prompts[i])
                                       for i in range(WHISPER_REQUESTS)], gen,
                       batch=WHISPER_BATCH, prompt_len=WHISPER_FRAMES, cap=WHISPER_CAP,
                       frames_rng=rng)


def phase_whisper(smi: str):
    """Whisper-base at full width and depth: served with
    attn_mode="pallas" through ``serve_loop`` and ``make_run_wave``'s encdec
    branch after a warm-up (the counts set to 0 just before and read just
    after: ``flash_attention`` once per encoder layer per wave, non-causal
    at (WHISPER_BATCH, 8, WHISPER_FRAMES, 64) bf16; every launch held
    against its plain version), then the same parameters and frames with
    the plain attention (``ref``), f64 attention (the noise floor) and
    ``chunked``, held to the plain path by phase 18's rule; then training:
    the widths at depth TRAIN_CHECK_DEPTH in f32 on the card against the
    same code in f64 on the host (B = 1, S = WHISPER_CAP), and Whisper-base
    in bf16 (AdamW, remat, attn_mode="chunked": the kernel has no backward)
    for a warm-up and WHISPER_TRAIN_STEPS steps of B = WHISPER_TRAIN_B ×
    S = WHISPER_CAP tokens and frames, launching no kernel.  Returns
    (launches, the first wave's first and last encoder layer's kernel
    calls, the report)."""
    from dataclasses import replace

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.api import build_model, make_train_step
    from repro_torch.train.optimizer import AdamW, tree_leaves, tree_map

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    base = get_config(WHISPER_ARCH)
    t0 = time.perf_counter()
    model = build_model(replace(base, attn_mode="pallas"))
    params = model.init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_l, waves = base.n_enc_layers, WHISPER_REQUESTS // WHISPER_BATCH
    log(f"{WHISPER_ARCH}: {n_params / 1e6:.4f} M parameters (ModelConfig.n_params(), which "
        f"counts no norm: {base.n_params()}; {base.dtype}, "
        f"{sum(_bytes(t) for t in _leaves(params)) / 1e9:.4f} GB; {held / 1e9:.2f} GB held by "
        f"earlier phases); {base.n_enc_layers} + {base.n_layers} layers; {WHISPER_REQUESTS} "
        f"requests of {WHISPER_FRAMES} stub frames, batch {WHISPER_BATCH}, {WHISPER_GEN} "
        f"generated, cache {WHISPER_CAP}; set-up {time.perf_counter() - t0:.1f} s")
    whisper_serve(model, params, gen=2)  # warm-up: library handles, the allocator
    torch.cuda.reset_peak_memory_stats()
    with recording(("flash_attention",)) as captured:
        ops.reset_launches()
        out, logits, tracer, wall = whisper_serve(model, params)
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() - held
    if sorted(out) != list(range(WHISPER_REQUESTS)):
        raise AssertionError(f"{WHISPER_ARCH}: served {sorted(out)}")
    for rid, toks in out.items():
        if toks.shape != (WHISPER_GEN,) or not ((toks >= 0) & (toks < base.vocab)).all():
            raise AssertionError(f"{WHISPER_ARCH} request {rid}: tokens {toks}")
    if not all(bool(torch.isfinite(x).all()) for w in logits for x in w):
        raise AssertionError(f"{WHISPER_ARCH}: non-finite logits")
    if launches != {"flash_attention": n_l * waves} or len(captured) != n_l * waves:
        raise AssertionError(f"{WHISPER_ARCH}: launched {launches}, not flash_attention {n_l} "
                             "per wave")
    want = (WHISPER_BATCH, base.n_heads, WHISPER_FRAMES, base.d_head)
    for _, args, kw in captured:
        if tuple(args[0].shape) != want or args[0].dtype != torch.bfloat16 or kw["causal"]:
            raise AssertionError(f"{WHISPER_ARCH}: a flash_attention call at "
                                 f"{tuple(args[0].shape)} {args[0].dtype} {kw}, not {want} bf16 "
                                 "non-causal")
    # every launch of the path against its plain version on its inputs
    shares = [check_attention(f"{WHISPER_ARCH} flash_attention#{i}",
                              ops.flash_attention(*args, **kw), ref.flash_attention(*args, **kw),
                              args[2])[1] for i, (_, args, kw) in enumerate(captured)]
    args, kw = captured[0][1:]
    fa = {"ms": cuda_ms(lambda: ops.flash_attention(*args, **kw)),
          "library_ms": _library_ms("flash_attention", args, kw),
          "bound_ms": work("flash_attention", args, kw)[1] / PEAK_BF16_TC * 1e3,
          "worst_bound_share": max(shares)}
    report = {"card": smi, "pallas": _serve_numbers(tracer, wall, len(out), WHISPER_GEN,
                                                    WHISPER_BATCH * WHISPER_FRAMES),
              "peak_allocated_gb": peak / 1e9, "held_gb": held / 1e9, "n_params": n_params,
              "flash_attention": fa}
    log(f"{WHISPER_ARCH} (pallas): {len(out)} requests served, {waves} waves; launches "
        f"{launches}, each within the bf16 rule of its plain version (worst share of the "
        f"bound {max(shares):.4f}); a call at {want} bf16 non-causal {fa['ms']:.4f} ms, bound "
        f"{fa['bound_ms']:.4f} ms ({fa['ms'] / fa['bound_ms']:.2f}×), SDPA "
        f"{fa['library_ms']:.4f} ms; peak {peak / 1e9:.3f} GB above the {held / 1e9:.2f} GB held")
    runs = {"pallas": (out, logits)}
    for name, mode in (("ref", "ref"), ("exact", exact_attention), ("chunked", "chunked")):
        res = whisper_serve(build_model(replace(base, attn_mode=mode)), params)
        runs[name] = res[:2]
        if name != "exact":
            report[name] = _serve_numbers(res[2], res[3], len(res[0]), WHISPER_GEN,
                                          WHISPER_BATCH * WHISPER_FRAMES)
    _, noise, same, std = path_gap(runs["ref"][1], runs["exact"][1])
    report["noise_floor"] = {"max_abs": noise, "same_token_steps": same, "logit_std": std}
    log(f"{WHISPER_ARCH} noise floor: the plain path's logits differ from those with exactly "
        f"rounded (f64) encoder attention by up to {noise:.6g} ({noise / std:.4f} of their std "
        f"{std:.6g}) over the {same} steps fed the same tokens")
    for name in ("pallas", "chunked"):
        report[f"{name}_vs_ref"] = compare_paths(
            f"{WHISPER_ARCH} {name} vs ref", runs[name], runs["ref"], runs["exact"][1], noise,
            WHISPER_GEN, batch=WHISPER_BATCH, lead=0)
    del runs, logits, out
    r = report["pallas"]
    log(f"serving {WHISPER_ARCH} ({smi}): prefill (the encoder and the cross K/V) "
        f"{r['prefill_ms_per_wave']:.3f} ms per wave of {WHISPER_BATCH}×{WHISPER_FRAMES} frames "
        f"(ref {report['ref']['prefill_ms_per_wave']:.3f}, chunked "
        f"{report['chunked']['prefill_ms_per_wave']:.3f}); decode {r['decode_ms_per_step']:.3f} "
        f"ms per step of {WHISPER_BATCH} tokens; {r['tokens_per_s']:.6g} generated tokens/s; "
        f"request latency p50 {r['latency_p50_s']:.4f} s, p99 {r['latency_p99_s']:.4f} s")

    # training: the card f32 against the host f64 at depth TRAIN_CHECK_DEPTH
    cut = dict(n_layers=TRAIN_CHECK_DEPTH, n_enc_layers=TRAIN_CHECK_DEPTH)
    cfg2 = replace(base, dtype="float32", **cut)

    def batch_of(cfg, b, device):
        pipe = TokenPipeline(vocab=cfg.vocab, seq_len=WHISPER_CAP, global_batch=b, seed=0)
        return make_batch_fn(cfg, pipe, device)(0)

    model2 = build_model(cfg2)
    p2 = model2.init(torch.Generator("cuda").manual_seed(0))
    t0 = time.perf_counter()
    card = _grads_of(model2, p2, batch_of(cfg2, 1, "cuda"))
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = _grads_of(build_model(replace(cfg2, dtype="float64")),
                     tree_map(lambda t: t.detach().double().cpu(), p2), batch_of(cfg2, 1, "cpu"))
    report["train_card_vs_host_f64"] = _gap_report(
        f"{WHISPER_ARCH} card f32 vs host f64 ({TRAIN_CHECK_DEPTH} + {TRAIN_CHECK_DEPTH} layers "
        f"at full width, B=1, S={WHISPER_CAP} tokens and frames; card {t_card:.2f} s, host "
        f"{time.perf_counter() - t0:.1f} s)", card, host, TRAIN_LOSS_RTOL, TRAIN_GRAD_REL)
    del card, host, p2, model2

    # Whisper-base in bf16 at full depth
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    model = build_model(base)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    step, opt = make_train_step(model, AdamW(lr=TRAIN_LR), microbatch=1)
    state = opt.init(params)
    batch = batch_of(base, WHISPER_TRAIN_B, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    params, state, met = step(params, state, batch)  # warm-up: the first step
    losses = [float(met["loss"])]
    warm_s = time.perf_counter() - t0
    times = []
    for _ in range(WHISPER_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch)
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    trained = {k: v for k, v in ops.LAUNCHES.items() if v}
    tpeak = torch.cuda.max_memory_allocated() - held
    if trained:
        raise AssertionError(f"{WHISPER_ARCH} training launched {trained}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{WHISPER_ARCH} training losses {losses}: not finite or not below "
                             "the first")
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(params)):
        raise AssertionError(f"{WHISPER_ARCH}: a parameter is not finite after training")
    step_s = statistics.median(times)
    tokens = WHISPER_TRAIN_B * WHISPER_CAP
    model_flops = 6 * base.n_params() * tokens
    report["train"] = {
        "losses": losses, "warmup_s": warm_s, "step_ms": [t * 1e3 for t in times],
        "step_ms_median": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "peak_allocated_gb": tpeak / 1e9, "held_gb": held / 1e9, "model_flops": model_flops,
        "model_flops_share": model_flops / step_s / PEAK_BF16_TC}
    log(f"train ({smi}): {WHISPER_ARCH} {base.n_enc_layers} + {base.n_layers} layers bf16, "
        f"B={WHISPER_TRAIN_B}×S={WHISPER_CAP} tokens and frames, AdamW lr {TRAIN_LR}, remat, "
        f"chunked attention: losses {[round(x, 4) for x in losses]}; step {step_s * 1e3:.1f} ms "
        f"median of {WHISPER_TRAIN_STEPS} (synchronised; warm-up {warm_s:.2f} s), "
        f"{tokens / step_s:.0f} decoder tokens/s, peak allocated {tpeak / 1e9:.2f} GB above the "
        f"{held / 1e9:.2f} GB held, model-FLOPs share {model_flops / step_s / PEAK_BF16_TC:.4f} "
        f"(6·N·tokens = {model_flops:.4g} over 989 TFLOP/s); no kernel launched")
    del params, state, batch, met, model
    report["phase_s"] = time.perf_counter() - t_phase
    log("encdec: " + json.dumps(report))
    log(f"encdec phase took {report['phase_s']:.1f} s")
    return launches["flash_attention"], [captured[0], captured[n_l - 1]], report


# ---------------------------------------------------------------------------
# training the MoE, VLM, hybrid and RWKV families on the card
# ---------------------------------------------------------------------------


def _family_batch(cfg, b: int, s: int, device: str):
    """The launcher's batch of the family (``launch/train.py:make_batch_fn``:
    the VLM's stub embeddings and ``positions3``), TokenPipeline(seed=0)'s
    step 0, on ``device``."""
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import make_batch_fn

    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=s, global_batch=b, seed=0)
    return make_batch_fn(cfg, pipe, device)(0)


def _dropped(rec) -> tuple:
    """(choices dropped, choices made) over a ``routing()`` record."""
    keeps = [c[3] for c in rec["calls"]]
    return sum(int((~k).sum()) for k in keeps), sum(k.numel() for k in keeps)


def train_family(arch: str, smi: str) -> dict:
    """One family trained on the card through ``make_train_step``: full
    width at FAMILY_TRAIN's check depth in f32 on the card against f64 on
    the host (``phase_train``'s rule, with the host's own f32 run as the
    witness of f32's rounding, ``_gap_report``), and the same code in f64 on
    the card against the host's f64 (``phase_train``'s rule; a fault of the
    card's path shows there without f32's rounding; the MoE at capacity factor
    FAMILY_MOE_CHECK_CF, its drops counted, the host's routing pinned to
    the card's), then the bf16 cell at FAMILY_TRAIN's depth: AdamW at
    FAMILY_TRAIN's lr, B = TRAIN_B, remat, a warm-up and the timed steps
    with the launch counts set to 0 just before and read just after."""
    from dataclasses import replace

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model, make_train_step, value_and_grad
    from repro_torch.train.optimizer import AdamW, tree_leaves, tree_map

    t_fam = time.perf_counter()
    base = get_config(arch)
    c_depth, c_s, depth, seq, steps, lr, why = FAMILY_TRAIN[arch]
    rep: dict = {"card": smi}
    moe = base.is_moe
    # 1. the card in f32 against the host in f64, full width at the check depth
    over = {"n_layers": c_depth, "dtype": "float32"}
    if moe:
        over["moe_capacity_factor"] = FAMILY_MOE_CHECK_CF
    cfg2 = replace(base, **over)
    model2 = build_model(cfg2)
    p2 = model2.init(torch.Generator("cuda").manual_seed(0))
    t0 = time.perf_counter()
    with routing() as rec:
        card = _grads_of(model2, p2, _family_batch(cfg2, 1, c_s, "cuda"))
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    pin = [(None, ti.cpu(), po.cpu(), ke.cpu()) for _, ti, po, ke in rec["calls"]]
    t0 = time.perf_counter()
    with routing(pin=pin if moe else None):
        host = _grads_of(build_model(replace(cfg2, dtype="float64")),
                         tree_map(lambda t: t.detach().double().cpu(), p2),
                         _family_batch(cfg2, 1, c_s, "cpu"))
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    with routing(pin=pin if moe else None):
        host32 = _grads_of(build_model(cfg2), tree_map(lambda t: t.detach().cpu(), p2),
                           _family_batch(cfg2, 1, c_s, "cpu"))
    t_host32 = time.perf_counter() - t0
    # the same code in f64 on the card: what parts it from the host's f64 is
    # the rounding of the f32 the models keep at f64 (norms, RoPE, logits)
    t0 = time.perf_counter()
    with routing(pin=[(None, ti, po, ke) for _, ti, po, ke in rec["calls"]] if moe else None):
        card64 = _grads_of(build_model(replace(cfg2, dtype="float64")),
                           tree_map(lambda t: t.detach().double(), p2),
                           _family_batch(cfg2, 1, c_s, "cuda"))
    torch.cuda.synchronize()
    t_card64 = time.perf_counter() - t0
    # the host's gradients on the card, once, for the gaps' f64 arithmetic
    host, host32 = ((loss, tree_map(lambda t: t.cuda(), g)) for loss, g in (host, host32))
    what = (f"{c_depth} layers at full width, B=1, S={c_s}"
            + (f", capacity factor {FAMILY_MOE_CHECK_CF}, the host's routing pinned to the "
               f"card's" if moe else ""))
    rep["card_f64_vs_host_f64"] = _gap_report(f"{arch} card f64 vs host f64 ({what})", card64,
                                              host, TRAIN_LOSS_RTOL, TRAIN_GRAD_REL)
    rep["card_vs_host_f64"] = _gap_report(
        f"{arch} card f32 vs host f64 ({what}; card {t_card:.2f} s, host {t_host:.1f} s; host "
        f"f32 {t_host32:.1f} s, card f64 {t_card64:.2f} s)",
        card, host, TRAIN_LOSS_RTOL, TRAIN_GRAD_REL, witness=host32)
    if moe:
        dropped, made = _dropped(rec)
        if not dropped:
            raise AssertionError(f"{arch}: the check dropped no choice at capacity factor "
                                 f"{FAMILY_MOE_CHECK_CF}: the capacity code went unchecked")
        rep["card_vs_host_f64"]["dropped"] = [dropped, made]
        log(f"train check {arch}: {dropped} of {made} (token, k) choices dropped at capacity "
            f"factor {FAMILY_MOE_CHECK_CF} (the router's calls, recompute included)")
    del card, card64, host, host32, p2, model2, rec, pin
    gc.collect()
    torch.cuda.empty_cache()
    rep["check_s"] = time.perf_counter() - t_fam

    # 2. the bf16 cell at the depth that fits
    cfg = replace(base, n_layers=depth)
    held = torch.cuda.memory_allocated()
    model = build_model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    step, opt = make_train_step(model, AdamW(lr=lr), microbatch=1)
    state = opt.init(params)
    batch = _family_batch(cfg, TRAIN_B, seq, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"training {arch}: {depth} of {base.n_layers} layers at full width ({why}); "
        f"{n_params / 1e9:.4f} B parameters ({cfg.dtype}), B={TRAIN_B}, S={seq}, remat "
        f"{cfg.remat}, attention {cfg.attn_mode}, lr {lr}")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with routing() as rec:
        params, state, met = step(params, state, batch)  # warm-up: the first step
        losses = [float(met["loss"])]
        warm_s = time.perf_counter() - t0
        drop = _dropped(rec)
        rec["calls"].clear()
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            params, state, met = step(params, state, batch)
            losses.append(float(met["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        drops = [_dropped({"calls": rec["calls"]})]
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() - held
    if launches:
        raise AssertionError(f"{arch} training launched {launches}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{arch} training losses {losses}: not finite or not falling")
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(params)):
        raise AssertionError(f"{arch}: a parameter is not finite after training")
    parts = {}

    def part_peak(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        got = fn()
        torch.cuda.synchronize()
        return got, (torch.cuda.max_memory_allocated() - held) / 1e9

    (_, grads), parts["loss and gradients"] = part_peak(
        lambda: value_and_grad(model.loss, params, batch))
    _, parts["AdamW update"] = part_peak(lambda: opt.update(grads, state, params))
    del grads, _
    step_s = statistics.median(times)
    tokens = TRAIN_B * seq
    model_flops = 6 * cfg.n_active_params() * tokens
    rep["cell"] = {
        "layers": depth, "of_layers": base.n_layers, "cut": why, "seq": seq, "batch": TRAIN_B,
        "n_params": n_params, "n_active_params": cfg.n_active_params(), "losses": losses,
        "warmup_s": warm_s, "step_ms": [t * 1e3 for t in times],
        "step_ms_median": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "peak_allocated_gb": peak / 1e9, "peak_gb_by_part": parts, "held_gb": held / 1e9,
        "model_flops": model_flops, "model_flops_share": model_flops / step_s / PEAK_BF16_TC}
    share = ""
    if moe:
        dropped, made = drops[0]
        rep["cell"]["dropped_share"] = dropped / made
        rep["cell"]["dropped_share_warmup"] = drop[0] / drop[1]
        share = (f"; {dropped / made:.4f} of the (token, k) choices dropped over the timed "
                 f"steps (capacity factor {cfg.moe_capacity_factor})")
    log(f"train ({smi}): {arch} {depth} of {base.n_layers} layers {cfg.dtype}, B={TRAIN_B}×S={seq}: "
        f"losses {[round(x, 4) for x in losses]}; step {step_s * 1e3:.1f} ms median of {steps} "
        f"(synchronised; warm-up {warm_s:.2f} s), {tokens / step_s:.0f} tokens/s, peak "
        f"allocated {peak / 1e9:.2f} GB above the {held / 1e9:.2f} GB held "
        f"({', '.join(f'{k} {v:.2f}' for k, v in parts.items())}), model-FLOPs share "
        f"{model_flops / step_s / PEAK_BF16_TC:.4f} (6·N·tokens = {model_flops:.4g}"
        + (f", N the {cfg.n_active_params() / 1e9:.4f} B active parameters: top-{cfg.top_k} of "
           f"{cfg.n_experts} experts" if moe else "") + f", over 989 TFLOP/s dense bf16)"
        + share + "; no kernel launched")
    del params, state, batch, met, model, rec
    gc.collect()
    torch.cuda.empty_cache()
    rep["phase_s"] = time.perf_counter() - t_fam
    log(f"train {arch} took {rep['phase_s']:.1f} s (the check {rep['check_s']:.1f} s)")
    return rep


def phase_train_families(smi: str) -> dict:
    """Training the MoE, VLM, hybrid and RWKV families on the card
    (``train_family`` each, in FAMILY_TRAIN's order)."""
    t_phase = time.perf_counter()
    report = {arch: train_family(arch, smi) for arch in FAMILY_TRAIN}
    report["phase_s"] = time.perf_counter() - t_phase
    log("train families: " + json.dumps(report))
    log(f"train families phase took {report['phase_s']:.1f} s")
    return report


# ---------------------------------------------------------------------------
# the compile driver: cost search, plan store, admission, the fallback
# ladder, taps and feedback, control flow
# ---------------------------------------------------------------------------


def sync(dev: str) -> None:
    import torch

    if str(dev).startswith("cuda"):
        torch.cuda.synchronize()


def run_ms(fn, dev: str, reps: int) -> float:
    """Median host ms of ``fn()`` over ``reps`` runs, the card synchronised
    before and after each (after one warm-up)."""
    fn()
    times = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_cost(tables, ctx, frames, reps: int, dev: str = "cuda") -> None:
    """The six queries with ``optimize="cost"`` and a fresh ``PlanCache``,
    sequential and with ``parallel=4``, against the numpy references: per
    query the chosen strategy, the number of candidates (16), the search's
    compile ms against the fixed path's miss compile ms, and the chosen
    plan's execute ms against the default strategy's.  Then a fresh cache
    on a temporary ``PlanStore``: the second compile replays the stored
    strategy (``cache_source == "store"``), timed, and answers right."""
    import tempfile

    from repro_torch.compiler import PlanCache, PlanStore
    from repro_torch.frontends.dataflow import _to_numpy
    from repro_torch.relational import tpch

    srcs = ctx.sources(dev)
    refs = {q: tpch.REFERENCES[q](tables) for q in frames}
    summary = {}
    for par in (None, PARALLEL):
        mode = "sequential" if par is None else f"parallel={PARALLEL}"
        cache = PlanCache()
        for q, frame in frames.items():
            check_query(q, frame.collect(device=dev, parallel=par, optimize="cost",
                                         cache=cache), refs[q])
            chosen = ctx.compile(frame, device=dev, parallel=par, optimize="cost", cache=cache)
            default = ctx.compile(frame, device=dev, parallel=par, cache=cache)
            if not chosen.cache_hit or len(chosen.decision.candidates) != 16:
                raise AssertionError(f"cost {q} {mode}: hit {chosen.cache_hit}, "
                                     f"{len(chosen.decision.candidates)} candidates")
            search = run_ms(lambda: ctx.compile(frame, device=dev, parallel=par,
                                                optimize="cost", cache=False), dev, reps)
            fixed = run_ms(lambda: ctx.compile(frame, device=dev, parallel=par, cache=False),
                           dev, reps)
            ex_chosen = run_ms(lambda: _to_numpy(chosen(srcs)[0]), dev, reps)
            ex_default = run_ms(lambda: _to_numpy(default(srcs)[0]), dev, reps)
            row = {"strategy": dict(chosen.strategy), "candidates": 16,
                   "search_compile_ms": search, "fixed_compile_ms": fixed,
                   "chosen_execute_ms": ex_chosen, "default_execute_ms": ex_default,
                   "default_is_chosen": chosen.strategy == default.strategy}
            summary.setdefault(mode, {})[q] = row
            log(f"cost {q} {mode}: chose {json.dumps(row['strategy'])} of 16 candidates; "
                f"search compile {search:.3f} ms against the fixed path's {fixed:.3f} ms; "
                f"execute {ex_chosen:.3f} ms against the default strategy's {ex_default:.3f} "
                f"ms (medians of {reps}); matches the numpy reference")
    log("cost: " + json.dumps(summary))

    with tempfile.TemporaryDirectory(prefix="plan-store-") as root:
        store, replay = PlanStore(root), {}
        for q, frame in frames.items():
            ctx.compile(frame, device=dev, optimize="cost", cache=PlanCache(), store=store)
            sync(dev)
            t0 = time.perf_counter()
            res = ctx.compile(frame, device=dev, optimize="cost", cache=PlanCache(),
                              store=store)
            replay[q] = (time.perf_counter() - t0) * 1e3
            if res.cache_source != "store" or res.decision.source != "store":
                raise AssertionError(f"plan store {q}: source {res.cache_source}")
            check_query(q, _to_numpy(res(srcs)[0]), refs[q])
        log(f"plan store: {len(store)} records; a fresh cache replays each query's stored "
            f"strategy (cache_source=store) and answers right; replay compile ms "
            f"{json.dumps(replay)}")


def peak_rise(fn, dev: str) -> int:
    """Bytes the caching allocator's peak rose by while ``fn()`` ran."""
    import torch

    sync(dev)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    sync(dev)
    return torch.cuda.max_memory_allocated() - base


#: the strategies phase_admission runs the six queries under
ADMISSION_STRATEGIES = {"port": None, "sorted": SORTED, "dict": {"encode": "dict"},
                        "unfused": {"fuse": "unfused"}}


def phase_admission(tables, ctx, frames, dev: str = "cuda") -> None:
    """Admission on the card (``robust/admission.py``'s model of the port's
    own allocations, ROADMAP Queue 3 item 14).  The six queries under each
    of ADMISSION_STRATEGIES, each admitted under the card's total memory:
    the estimate's peak bytes beside the caching allocator's measured rise
    while the plan's first run ran, which must not exceed it.  Q4 under a
    budget of the cheaper tier's largest estimate (which tier that is, the
    model says): the cost search keeps exactly the candidates estimated
    within it and answers as numpy does; one byte below every estimate it
    rejects all.  Item 14's input, a group-by of 2^16 rows over keys in
    [0, 10^6), under the sorted and the direct tier, each rise within its
    estimate; under a budget one byte below the direct estimate the search
    drops the direct candidates, picks a sorted one and answers as numpy
    does."""
    import numpy as np
    import torch

    from repro_torch.compiler import PlanCache
    from repro_torch.frontends.dataflow import Context, _to_numpy, count_, sum_
    from repro_torch.relational import tpch
    from repro_torch.robust.admission import AdmissionError, estimate_peak_bytes

    srcs = ctx.sources(dev)
    total = torch.cuda.mem_get_info()[1]
    peaks, over = {}, []

    def admitted(what, res, run):
        if res.degraded or res.resources is None:
            raise AssertionError(f"admission {what}: {res.degraded}, {res.resources}")
        out = {}
        rise = peak_rise(lambda: out.update(_to_numpy(run()[0])), dev)
        est = res.resources.peak_bytes
        peaks[what] = {"estimate": est, "measured_rise": rise, "ratio": rise / max(est, 1),
                       "site": res.resources.peak_site}
        if rise > est:
            over.append(what)
        log(f"admission {what}: estimate {est} bytes at {res.resources.peak_site}, measured "
            f"peak rise {rise} bytes ({rise / max(est, 1):.4f} of the estimate)")
        return out

    for label, strategy in ADMISSION_STRATEGIES.items():
        for q, frame in frames.items():
            res = ctx.compile(frame, device=dev, cache=False, memory_budget=total,
                              strategy=strategy)
            check_query(q, admitted(f"{q}/{label}", res, lambda: res(srcs)),
                        tpch.REFERENCES[q](tables))

    q4 = frames["q4"]
    search = ctx.compile(q4, device=dev, cache=False, optimize="cost")
    ests = {c.strategy: estimate_peak_bytes(ctx.compile(
        q4, device=dev, cache=False, strategy=dict(c.strategy)).program).peak_bytes
        for c in search.decision.candidates}
    by_tier = {}
    for s_, e in ests.items():
        by_tier.setdefault(dict(s_)["groupby"], []).append(e)
    cheap = min(by_tier, key=lambda t: max(by_tier[t]))
    budget = max(by_tier[cheap])
    within = {s_ for s_, e in ests.items() if e <= budget}
    res = ctx.compile(q4, device=dev, cache=PlanCache(), optimize="cost", memory_budget=budget)
    kept = {c.strategy for c in res.decision.candidates}
    if res.degraded or kept != within or res.resources.peak_bytes > budget:
        raise AssertionError(f"admission q4: kept {sorted(kept)}, the model admits "
                             f"{sorted(within)} under {budget}; chose {res.strategy}")
    check_query("q4", _to_numpy(res(srcs)[0]), tpch.REFERENCES["q4"](tables))
    try:
        ctx.compile(q4, device=dev, cache=False, optimize="cost", guard=False,
                    memory_budget=min(ests.values()) - 1)
        raise AssertionError("admission q4: a budget below every estimate admitted a plan")
    except AdmissionError as e:
        rejected = str(e).splitlines()[0]
    tiers = {t: [min(es), max(es)] for t, es in by_tier.items()}
    log(f"admission q4: estimates by group-by tier (least, most) {json.dumps(tiers)}; the "
        f"{cheap} tier is the cheaper; under a budget of {budget} the search kept "
        f"{len(kept)} candidates ({sorted({dict(k)['groupby'] for k in kept})}), chose "
        f"{json.dumps(dict(res.strategy))} and matches numpy; below every estimate it rejects "
        f"all ({rejected})")

    rng = np.random.default_rng(0)
    n, span = 1 << 16, 1_000_000
    wide = Context(pad_to=1024)
    wide.register("w", {"k": rng.integers(0, span, n).astype(np.int32),
                        "v": rng.normal(size=n).astype(np.float32)})
    frame = wide.table("w").group_by("k", max_groups=n).agg(sum_("v").as_("s"),
                                                            count_().as_("n"))
    k, v = wide.tables["w"]["k"], wide.tables["w"]["v"]
    keys, inv = np.unique(k, return_inverse=True)

    def check_wide(what, out):
        order = np.argsort(out["k"])
        np.testing.assert_array_equal(out["k"][order], keys, err_msg=what)
        np.testing.assert_array_equal(out["n"][order], np.bincount(inv), err_msg=what)
        np.testing.assert_allclose(out["s"][order], np.bincount(inv, v.astype(np.float64)),
                                   rtol=QUERY_RTOL, atol=1e-4, err_msg=what)

    wsrcs = wide.sources(dev)
    for tier in ("sorted", "direct"):
        res = wide.compile(frame, device=dev, cache=False, strategy={"groupby": tier},
                           memory_budget=total)
        check_wide(f"wide {tier}", admitted(f"wide/{tier}", res, lambda: res(wsrcs)))
    est = estimate_peak_bytes(wide.compile(frame, device=dev, cache=False,
                                           strategy={"groupby": "direct"}).program)
    res = wide.compile(frame, device=dev, cache=PlanCache(), optimize="cost",
                       strategy={"encode": "raw"}, memory_budget=est.peak_bytes - 1)
    if res.degraded or dict(res.strategy)["groupby"] != "sorted" or any(
            dict(c.strategy)["groupby"] == "direct" for c in res.decision.candidates):
        raise AssertionError(f"admission wide: {res.strategy}, {res.decision.records()}")
    check_wide("wide searched", admitted("wide/searched", res, lambda: res(wsrcs)))
    log(f"admission wide group-by ({n} rows, keys over {span}): direct estimate "
        f"{est.peak_bytes} bytes; under a budget one byte below it the search dropped the "
        f"direct candidates and chose {json.dumps(dict(res.strategy))}; matches numpy")
    log("admission: " + json.dumps(peaks))
    if over:
        raise AssertionError(f"admission: measured rises above their estimates: "
                             f"{ {w: peaks[w] for w in over} }")
    log(f"admission: {len(peaks)} plans, every measured rise within its estimate (largest "
        f"ratio {max(p['ratio'] for p in peaks.values()):.4f})")


def phase_fallback(tables, ctx, frames, dev: str = "cuda") -> None:
    """The fallback ladder on the card.  Q1 with ``backend.execute``
    injected to raise once: the first rung (``groupby=sorted``) answers;
    then injected at every rung down to ``interp`` (numpy on the host at
    this scale); each answer against the numpy reference, the ms per rung
    from the trace's ``robust.fallback`` events.  Then Q1 whose
    ``grouped_select_agg`` refuses its inputs (its own bucket check) or runs
    out of the card's memory: ``collect()`` must raise ``KernelLaunchError``
    under ``guard=True`` with no rung walked.  Then a subprocess whose build
    directory is empty and whose ``nvcc`` cannot be found: its ``collect()``
    must raise ``KernelBuildError`` under ``guard=True``."""
    import os
    import tempfile
    import textwrap
    import warnings

    import torch

    from repro_torch.compiler import PlanCache
    from repro_torch.errors import KernelLaunchError
    from repro_torch.kernels import ops as kops
    from repro_torch.frontends.dataflow import _to_numpy
    from repro_torch.obs import DegradedWarning, tracing
    from repro_torch.relational import tpch
    from repro_torch.robust.inject import inject

    srcs = ctx.sources(dev)
    want = tpch.REFERENCES["q1"](tables)
    for times, rungs in ((1, ("groupby=sorted",)),
                         (4, ("groupby=sorted", "join=sorted", "fuse=unfused", "interp"))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with tracing() as tr, inject("backend.execute", times=times):
                res = ctx.compile(frames["q1"], device=dev, cache=PlanCache())
                got = _to_numpy(res(srcs)[0])
                sync(dev)
                end = time.perf_counter() - tr.epoch
        check_query("q1", got, want)
        steps = [e for e in tr.events if e["name"] == "robust.fallback"]
        warned = [w for w in caught if issubclass(w.category, DegradedWarning)]
        if res.degraded != rungs or len(warned) != len(rungs) or len(steps) != len(rungs):
            raise AssertionError(f"fallback q1 ×{times}: degraded {res.degraded}, "
                                 f"{len(warned)} warnings")
        ts = [e["ts"] for e in steps] + [end]
        per_rung = {r: (ts[i + 1] - ts[i]) * 1e3 for i, r in enumerate(rungs)}
        log(f"fallback q1, backend.execute injected {times}×: degraded via "
            f"{' → '.join(res.degraded)} (target {res.target}); matches the numpy reference; "
            f"ms per rung {json.dumps(per_rung)}")

    real = kops.grouped_select_agg

    def refused(t, pred, keys, aggs, mg, domains, nb):
        return real(t, pred, keys, aggs, mg, domains, nb + 1)

    def out_of_memory(*args, **kw):
        raise torch.OutOfMemoryError("CUDA out of memory (raised on purpose)")

    for what, failing in (("refuses its inputs", refused),
                          ("runs out of memory", out_of_memory)):
        kops.grouped_select_agg = failing
        try:
            frames["q1"].collect(device=dev, cache=PlanCache(), guard=True)
        except KernelLaunchError as e:
            log(f"fallback q1 whose grouped_select_agg {what}: collect() under guard=True "
                f"raised KernelLaunchError ({str(e).splitlines()[0][:120]}); no rung walked")
        else:
            raise AssertionError(f"fallback q1 whose grouped_select_agg {what}: answered")
        finally:
            kops.grouped_select_agg = real

    code = textwrap.dedent(f"""
        import sys, warnings
        sys.path.insert(0, {str(ROOT / 'src')!r})
        from repro_torch.kernels import build
        build.DEFAULT_NVCC = "/nonexistent/bin/nvcc"
        from repro_torch.obs import DegradedWarning
        from repro_torch.relational import tpch
        warnings.simplefilter("error", DegradedWarning)
        ctx = tpch.make_context(tpch.generate(sf=0.01, seed=0))
        try:
            tpch.q6(ctx).collect(device={dev!r}, guard=True)
        except Exception as e:
            print("raised", type(e).__name__, str(e).splitlines()[0])
        else:
            print("answered")
    """)
    with tempfile.TemporaryDirectory(prefix="empty-build-") as empty:
        env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
        env["REPRO_TORCH_BUILD_DIR"] = empty
        env["PATH"] = os.pathsep.join(p for p in env.get("PATH", "").split(os.pathsep)
                                      if p and not (Path(p) / "nvcc").exists())
        out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                             text=True, timeout=300)
    said = out.stdout.strip().splitlines()[-1:] or [out.stderr.strip()[-500:]]
    if out.returncode != 0 or not said[0].startswith("raised KernelBuildError"):
        raise AssertionError(f"fallback without nvcc: exit {out.returncode}, {said}")
    log(f"fallback without nvcc (empty build directory): collect() under guard=True "
        f"{said[0]}; no rung walked")


#: the stream phase: lineitem delivered in micro-batches of this many rows,
#: the queries it folds (by name; "revenue" is the per-order state), the
#: kernel and route each query's batches launch, and the snapshot cadence
STREAM_BATCH = 65_536
STREAM_QUERIES = ("q1", "q6", "q12", "q14", "q19", "revenue")
STREAM_KERNEL = {"q1": ("grouped_select_agg", "gsa_reg"), "q6": ("fused_select_agg", "fsa_gen"),
                 "q12": ("grouped_join_agg", "gja_reg"), "q14": ("fused_select_agg", "fsa_gen"),
                 "q19": ("fused_select_agg", "fsa_gen"),
                 "revenue": ("grouped_select_agg", "gsa_global")}
STREAM_SNAPSHOT_EVERY = 16
#: folds that must give the uninterrupted fold's bits after a recovery: every
#: stream query and the revenue state (every kernel route adds in a fixed
#: order or as integers, the merge two values a bucket), and Q1 under the
#: sorted tiers (its segment sums are runtime.fixed_sum's integers on the
#: card); and the batch the kill
#: hits
STREAM_SAME_BITS = STREAM_QUERIES + ("q1_sorted",)
STREAM_KILL_AT = 24


def revenue_query(ctx, n_orders: int):
    """Revenue per order: a continuous per-key aggregate whose carried state
    holds one group per order (GroupAggDirect on grouped_select_agg)."""
    from repro_torch.core.expr import col
    from repro_torch.frontends.dataflow import count_, max_, sum_

    return (ctx.table("lineitem").group_by("l_orderkey", max_groups=n_orders)
            .agg(sum_(col("l_extendedprice") * (1.0 - col("l_discount"))).as_("rev"),
                 count_().as_("n"), max_("l_shipdate").as_("last")))


def ref_revenue(tables) -> dict:
    """numpy's per-order answer in f64 (bincount), the orders with lines."""
    import numpy as np

    li = tables["lineitem"]
    k = li["l_orderkey"].astype(np.int64)
    rev = np.bincount(k, li["l_extendedprice"].astype(np.float64)
                      * (1.0 - li["l_discount"].astype(np.float64)))
    n = np.bincount(k)
    last = np.full(len(n), -np.inf)
    np.maximum.at(last, k, li["l_shipdate"].astype(np.float64))
    has = np.nonzero(n)[0]
    return {"l_orderkey": has.astype(np.int32), "rev": rev[has], "n": n[has],
            "last": last[has]}


def check_stream_answer(q: str, got, tables) -> None:
    if q == "revenue":
        check_query(q, got, ref_revenue(tables))
    else:
        from repro_torch.relational import tpch

        check_query(q, got, tpch.REFERENCES[q](tables))


def _fold(res, srcs, batches, dev: str, **kw):
    """A fresh StreamConsumer over ``batches`` (bind and init_state
    included); returns it and the host seconds of the process loop, which
    ends in a device synchronisation."""
    from repro_torch.launch.serve import StreamConsumer

    c = StreamConsumer(res, srcs, **kw)
    sync(dev)
    t0 = time.perf_counter()
    for mb in batches:
        c.process(mb)
    sync(dev)
    return c, time.perf_counter() - t0


def _fold_s(res, srcs, batches, dev: str, reps: int, **kw) -> float:
    """Median seconds of the process loop over ``reps`` folds, after one."""
    _fold(res, srcs, batches, dev, **kw)
    return statistics.median(_fold(res, srcs, batches, dev, **kw)[1] for _ in range(reps))


def _split_batches(res, srcs, batches, dev: str):
    """One pass of the fold split into its parts, the card synchronised
    around each: median ms per batch of the host→device copy
    (``as_batch``), the batch segment and the merge."""
    ex = res.executable.bind(srcs)
    state = ex.init_state()
    copy, seg, merge = [], [], []
    for mb in batches:
        sync(dev)
        t0 = time.perf_counter()
        vt = ex.as_batch(mb.rows)
        sync(dev)
        t1 = time.perf_counter()
        (delta,) = ex._batch({ex.stream_table: vt}, *ex._batch_args)
        sync(dev)
        t2 = time.perf_counter()
        (state,) = ex._merge({}, state, delta)
        sync(dev)
        t3 = time.perf_counter()
        copy.append((t1 - t0) * 1e3)
        seg.append((t2 - t1) * 1e3)
        merge.append((t3 - t2) * 1e3)
    return {"copy_ms": statistics.median(copy), "batch_ms": statistics.median(seg),
            "merge_ms": statistics.median(merge)}


def _dir_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def phase_stream(tables, ctx, frames, reps: int, dev: str = "cuda"):
    """The stream target on the card: lineitem from the host copy in
    micro-batches of STREAM_BATCH rows (``microbatches``), orders and part
    static on the card.  Per query (Q1, Q6, Q12, Q14, Q19 under the port's
    default strategy, and the per-order revenue state): its four segments,
    one fold with the counts set to 0 just before and read just after (one
    launch of its kernel per batch plus init_state's, on its route), the
    init, first and ragged last kernel calls against their plain versions,
    the answer against numpy; the fold's rows/s (median of ``reps`` after a
    warm-up) beside the batch path's, and ms per batch split into copy,
    batch segment and merge.  Q1 under the sorted tiers too (its batch face
    and its fold); Q4 must raise lower_stream's named error.  Q1 and the
    revenue state with a ``CheckpointManager`` every STREAM_SNAPSHOT_EVERY
    batches: snapshot ms and bytes, the checkpointed fold over the bare
    one.  Exactly-once: ``stream_loop`` with ``stream.batch`` killed at
    batch STREAM_KILL_AT (recovery ms, batches replayed) and a second
    consumer restoring a dead one's snapshots and redelivered every batch
    (dedups restored + 1), on every query, the
    revenue state (``gsa_global``) and Q1 under the sorted tiers: each must
    give the uninterrupted fold's bits (``STREAM_SAME_BITS``).  Last,
    ``grouped_select_agg`` refusing mid-stream: ``KernelLaunchError`` out
    of ``stream_loop`` with no restore.  Returns the launches per kernel
    of the counted folds."""
    import tempfile

    from repro_torch.compiler import PlanCache
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.errors import KernelLaunchError
    from repro_torch.frontends.dataflow import _to_numpy
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch.serve import StreamConsumer, microbatches, stream_loop
    from repro_torch.obs import tracing
    from repro_torch.relational import tpch
    from repro_torch.robust.inject import inject

    srcs = ctx.sources(dev)
    n_li = len(tables["lineitem"]["l_orderkey"])
    n_orders = len(tables["orders"]["o_orderkey"])
    batches = microbatches(ctx.tables["lineitem"], STREAM_BATCH)
    n_b = len(batches)
    frames = dict(frames, revenue=revenue_query(ctx, n_orders))
    log(f"stream: lineitem {n_li} rows from the host in {n_b} micro-batches of {STREAM_BATCH} "
        f"(last {batches[-1].n_rows}); orders and part static on the card; per-order state "
        f"{n_orders} groups")

    def compile_stream(q, **kw):
        return ctx.compile(frames[q], target="stream", stream_table="lineitem",
                           batch_rows=STREAM_BATCH, device=dev, cache=PlanCache(), **kw)

    built0 = build.GEN_STATS["built"]
    launches = {k: 0 for k in TPCH_KERNELS}
    compiled, answers, summary = {}, {}, {}
    for q in STREAM_QUERIES:
        res = compiled[q] = compile_stream(q)
        plan = res.executable.plan
        segs = {s: (None if p is None else [i.opcode for i in p.body])
                for s, p in (("static", plan.static_program), ("batch", plan.batch_program),
                             ("merge", plan.merge_program),
                             ("finalize", plan.finalize_program))}
        kname, route = STREAM_KERNEL[q]
        with recording(TPCH_KERNELS) as captured:
            ops.reset_launches()
            before = dict(ops.GEN_LAUNCHES)
            c, _ = _fold(res, srcs, batches, dev, snapshot_every=10 ** 9)
            counted_l = {k: v for k, v in ops.LAUNCHES.items() if v}
            took = {r: ops.GEN_LAUNCHES[r] - before[r] for r in before
                    if ops.GEN_LAUNCHES[r] != before[r]}
        got = answers[q] = _to_numpy(c.results()[0])
        check_stream_answer(q, got, tables)
        if counted_l != {kname: n_b + 1} or took != {route: n_b + 1}:
            raise AssertionError(f"stream {q}: launched {counted_l}, routes {took}; want "
                                 f"{kname} on {route} {n_b + 1} times")
        for k in TPCH_KERNELS:
            launches[k] += counted_l.get(k, 0)
        samples = {}
        for label, (name, args, kw) in (("init", captured[0]), ("first", captured[1]),
                                        ("last", captured[-1])):
            kern, plain = getattr(ops, name), getattr(ref, name)
            err = compare_outputs(f"stream {q} {name} {label}", kern(*args, **kw),
                                  plain(*args, **kw))
            samples[label] = {"valid_rows": int(args[0].valid.sum()), "max_abs_err": err,
                              "ms": cuda_ms(lambda: kern(*args, **kw)),
                              "plain_ms": cuda_ms(lambda: plain(*args, **kw))}
        del captured
        fold_s = _fold_s(res, srcs, batches, dev, reps, snapshot_every=10 ** 9)
        parts = _split_batches(res, srcs, batches, dev)
        batch_ms = run_ms(lambda: frames[q].collect(device=dev, cache=False), dev, reps)
        summary[q] = {"segments": segs, "launches": counted_l, "routes": took,
                      "samples": samples, "fold_ms": fold_s * 1e3,
                      "rows_per_s": n_li / fold_s, "ms_per_batch": fold_s * 1e3 / n_b,
                      **parts, "batch_path_ms": batch_ms,
                      "batch_path_rows_per_s": n_li / (batch_ms / 1e3),
                      "batch_path_over_stream": (n_li / (batch_ms / 1e3)) / (n_li / fold_s)}
        log(f"stream {q}: segments {json.dumps(segs)}")
        log(f"stream {q}: matches numpy; {kname} on {route} {n_b + 1} times (one a batch and "
            f"init_state's); init/first/last calls match their plain versions "
            f"{json.dumps(samples)}; fold {n_li / fold_s:.4g} rows/s "
            f"({fold_s * 1e3 / n_b:.3f} ms a batch: copy {parts['copy_ms']:.3f}, batch "
            f"{parts['batch_ms']:.3f}, merge {parts['merge_ms']:.3f}); batch path "
            f"{n_li / (batch_ms / 1e3):.4g} rows/s, "
            f"{summary[q]['batch_path_over_stream']:.3g}x the stream's")

    res = compiled["q1_sorted"] = compile_stream("q1", strategy=SORTED)
    check_stream_answer("q1", _to_numpy(res(srcs)[0]), tables)
    c, _ = _fold(res, srcs, batches, dev, snapshot_every=10 ** 9)
    got = answers["q1_sorted"] = _to_numpy(c.results()[0])
    check_stream_answer("q1", got, tables)
    log(f"stream q1 under the sorted tiers ({json.dumps(SORTED)}): its batch face and its "
        "fold match numpy")
    try:
        compile_stream("q4", guard=True)
    except ValueError as e:
        if "2 aggregations over the stream" not in str(e):
            raise
        log(f"stream q4: raised ValueError under guard=True ({str(e)[:140]})")
    else:
        raise AssertionError("stream q4 compiled")
    built = build.GEN_STATS["built"] - built0
    log(f"stream: {int(built)} generated kernel libraries built by this phase (the TPC-H "
        "queries reuse the batch path's; the per-order query's is new)")

    snaps = {}
    with tempfile.TemporaryDirectory(prefix="stream-ckpt-") as tmp:
        for q in ("q1", "revenue"):
            res = compiled[q]
            bare = summary[q]["fold_ms"] / 1e3
            kw = dict(snapshot_every=STREAM_SNAPSHOT_EVERY)
            ck_s = _fold_s(res, srcs, batches, dev, reps,
                           checkpoint=CheckpointManager(Path(tmp) / q, n_shards=1, keep=2), **kw)
            with tracing() as tr:
                c, _ = _fold(res, srcs, batches, dev,
                             checkpoint=CheckpointManager(Path(tmp) / f"{q}-t", n_shards=1,
                                                          keep=2), **kw)
            snap = tr.histogram_summary("stream.snapshot_s")
            step = Path(tmp) / f"{q}-t" / f"step_{c.snapshot_seq:08d}"
            snaps[q] = {"snapshots": c.stats.snapshots, "snapshot_ms_p50": snap["p50"] * 1e3,
                        "snapshot_bytes": _dir_bytes(step), "checkpointed_fold_ms": ck_s * 1e3,
                        "bare_fold_ms": bare * 1e3, "overhead": ck_s / bare}
            log(f"stream checkpoint {q}: {c.stats.snapshots} snapshots of "
                f"{snaps[q]['snapshot_bytes']} bytes, {snap['p50'] * 1e3:.3f} ms each (p50); "
                f"checkpointed fold {ck_s * 1e3:.3f} ms over bare {bare * 1e3:.3f} ms = "
                f"{ck_s / bare:.4f} (the JAX package's CI guard is < 1.10; reported only)")

        exactly = {}
        for q in STREAM_SAME_BITS:
            res = compiled[q]
            with contextlib.ExitStack() as stack, tracing() as tr:
                def armed(stack=stack):
                    for i, mb in enumerate(batches):
                        if i == STREAM_KILL_AT:
                            stack.enter_context(inject("stream.batch", rate=1.0, times=1))
                        yield mb
                c = StreamConsumer(res, srcs, checkpoint=CheckpointManager(
                    Path(tmp) / f"{q}-kill", n_shards=1, keep=2),
                    snapshot_every=STREAM_SNAPSHOT_EVERY)
                out = _to_numpy(stream_loop(armed(), c, max_recoveries=3)[0])
                sync(dev)
            rec = tr.histogram_summary("stream.recovery_s")
            if c.stats.restores != 1 or c.stats.failures != 1:
                raise AssertionError(f"stream kill {q}: {c.stats}")
            first = StreamConsumer(res, srcs, checkpoint=CheckpointManager(
                Path(tmp) / f"{q}-dead", n_shards=1, keep=2),
                snapshot_every=STREAM_SNAPSHOT_EVERY)
            for mb in batches[:STREAM_KILL_AT]:
                first.process(mb)
            second = StreamConsumer(res, srcs, checkpoint=CheckpointManager(
                Path(tmp) / f"{q}-dead", n_shards=1, keep=2),
                snapshot_every=STREAM_SNAPSHOT_EVERY)
            restored = second.restore()
            for mb in batches:
                second.process(mb)
            if second.stats.deduped != restored + 1 or second.stats.batches != n_b - restored - 1:
                raise AssertionError(f"stream second consumer {q}: restored {restored}, "
                                     f"{second.stats}")
            again = _to_numpy(second.results()[0])
            same_result(f"stream {q} after a kill", out, answers[q])
            same_result(f"stream {q} on a second consumer", again, answers[q])
            check_stream_answer(q.split("_")[0], out, tables)
            kind = "the same bits as the uninterrupted fold, and numpy's answer"
            exactly[q] = {"recovery_ms": rec["p50"] * 1e3, "replayed": c.stats.replayed,
                          "restored_seq": restored, "deduped": second.stats.deduped,
                          "check": kind}
            log(f"stream exactly-once {q}: stream.batch killed at batch {STREAM_KILL_AT}, "
                f"recovered in {rec['p50'] * 1e3:.3f} ms replaying {c.stats.replayed} batches; "
                f"a second consumer restored seq {restored} and deduped "
                f"{second.stats.deduped} of {n_b} redelivered; both give {kind}")

    real = ops.grouped_select_agg
    calls = []

    def refused(t, pred, keys, aggs, mg, domains, nb):
        calls.append(1)
        if len(calls) > STREAM_KILL_AT:  # mid-stream: the wrapper's bucket check refuses
            nb += 1
        return real(t, pred, keys, aggs, mg, domains, nb)

    ops.grouped_select_agg = refused
    try:
        c = StreamConsumer(compiled["q1"], srcs, snapshot_every=STREAM_SNAPSHOT_EVERY)
        stream_loop(batches, c, max_recoveries=3)
    except KernelLaunchError as e:
        if c.stats.restores != 0:
            raise AssertionError(f"stream card fault: {c.stats.restores} restores walked")
        log(f"stream card fault: grouped_select_agg refused at batch {len(calls) - 2}; "
            f"KernelLaunchError out of stream_loop(max_recoveries=3) with "
            f"{c.stats.restores} restores ({str(e).splitlines()[0][:120]})")
    else:
        raise AssertionError("stream card fault: stream_loop answered")
    finally:
        ops.grouped_select_agg = real
    log("stream: " + json.dumps({"queries": summary, "checkpoint": snaps,
                                 "exactly_once": exactly, "generated_built": built,
                                 "batch_rows": STREAM_BATCH, "batches": n_b}))
    return launches


def phase_traced(tables, ctx, frames, reps: int, dev: str = "cuda") -> None:
    """The six queries under ``tracing()``: each profile has one
    observation per tapped operator of the plan, the scans measure the
    tables' rows and the last aggregation the numpy reference's result
    rows; the traced run's ms beside the plain run's.  Then
    ``enable_auto_replan``: Q1 compiled on statistics that claim 1,000
    lineitem rows misses its scan estimate on a traced run and re-plans by
    cost under the observed rows."""
    import numpy as np

    from repro_torch.compiler import (PlanCache, compile as cvm_compile,
                                      disable_auto_replan, enable_auto_replan)
    from repro_torch.frontends.dataflow import _to_numpy
    from repro_torch.obs import TAPPED_OPS, tracing
    from repro_torch.relational import tpch

    srcs = ctx.sources(dev)
    rows = {t: len(next(iter(cols.values()))) for t, cols in tables.items()}
    aggs = ("vec.GroupAggDirect", "vec.GroupAggSorted", "vec.FusedJoinGroupAgg",
            "vec.FusedSelectAgg", "vec.AggrVec")
    summary = {}
    for q, frame in frames.items():
        res = ctx.compile(frame, device=dev, cache=PlanCache())
        plain = run_ms(lambda: _to_numpy(res(srcs)[0]), dev, reps)

        def traced():
            with tracing():
                return _to_numpy(res(srcs)[0])
        traced_ms = run_ms(traced, dev, reps)
        check_query(q, traced(), tpch.REFERENCES[q](tables))
        prof = res.profile
        tapped = sum(ins.opcode in TAPPED_OPS and bool(ins.outputs)
                     for p in res.program.walk() for ins in p.body)
        if len(prof.observations) != tapped:
            raise AssertionError(f"traced {q}: {len(prof.observations)} observations for "
                                 f"{tapped} tapped operators")
        for o in prof.observations:
            if o.table is not None and o.rows_out != rows[o.table]:
                raise AssertionError(f"traced {q}: scan of {o.table} measured {o.rows_out}")
        want = tpch.REFERENCES[q](tables)
        first = np.asarray(next(iter(want.values())))
        want_rows = len(first) if first.ndim else 1
        last = [o for o in prof.observations
                if o.opcode in aggs and o.program == res.program.name][-1]
        if last.rows_out != want_rows:
            raise AssertionError(f"traced {q}: {last.opcode} measured {last.rows_out} rows, "
                                 f"numpy {want_rows}")
        summary[q] = {"plain_ms": plain, "traced_ms": traced_ms,
                      "observations": len(prof.observations),
                      "worst_miss": prof.worst_miss}
        log(f"traced {q}: {len(prof.observations)} observations, one per tapped operator; "
            f"scans and {last.opcode} measure numpy's rows ({want_rows}); worst miss "
            f"{prof.worst_miss}; traced {traced_ms:.3f} ms against plain {plain:.3f} ms "
            f"(medians of {reps})")
    log("traced: " + json.dumps(summary))

    catalog = ctx.catalog()
    catalog.stats = catalog.stats.with_observed_rows({"lineitem": 1000})
    res = cvm_compile(frames["q1"].program(), catalog, device=dev, cache=PlanCache())
    enable_auto_replan(threshold=1.0)
    try:
        with tracing() as tr:
            _to_numpy(res(srcs)[0])
    finally:
        disable_auto_replan()
    replans = [e for e in tr.events if e["name"] == "driver.replan"]
    if tr.counters.get("driver.replan") != 1 or res.decision is None:
        raise AssertionError(f"auto re-plan: {tr.counters}")
    check_query("q1", _to_numpy(res(srcs)[0]), tpch.REFERENCES["q1"](tables))
    log(f"auto re-plan q1: stale statistics (1000 lineitem rows) missed by "
        f"{replans[0]['worst_miss']:.1f}; re-planned by cost from "
        f"{json.dumps(replans[0]['old_strategy'])} to {json.dumps(replans[0]['new_strategy'])}"
        f" under {res.stats.table('lineitem').rows} observed rows; matches numpy")


def control_flow_programs():
    """Small programs of the other control-flow instructions: a ``cf.Cond``
    over (pred, x, y), a ``cf.Call`` and ``df.Source`` → ``df.Collect``."""
    from repro_torch.core import Builder, subprogram
    from repro_torch.core.types import BOOL, F32, Single, Tensor

    t, tb = Tensor(F32, (1024, 8)), Single(BOOL)

    def ew(b, op, *regs):
        return b.emit1("la.Ewise", list(regs), {"op": op})

    then = subprogram("then", [("x", t), ("y", t)], lambda b, r: [ew(b, "mul", *r)])
    other = subprogram("else", [("x", t), ("y", t)], lambda b, r: [ew(b, "sub", *r)])
    b = Builder("branched")
    regs = [b.input("pred", tb), b.input("x", t), b.input("y", t)]
    cond = b.finish(*b.emit("cf.Cond", regs, {"Pthen": then, "Pelse": other}))
    callee = subprogram("callee", [("x", t), ("y", t)], lambda b, r: [
        b.emit1("la.MMMult", [r[0], b.emit1("la.Transpose", [r[1]])])])
    b = Builder("caller")
    call = b.finish(*b.emit("cf.Call", [b.input("x", t), b.input("y", t)], {"P": callee}))
    b = Builder("sourced")
    source = b.finish(b.emit1("df.Collect", [b.emit1("df.Source", [], {"name": "t", "type": t})]))
    return cond, call, source


def phase_control_flow(dev: str = "cuda", n: int = KMEANS_N) -> None:
    """The k-means step as the body of a ``cf.Loop(n=5)`` at the k-means
    path's shape (2^24 points, d = 8, k = 16, seed 0), fused and split in 8
    (``kmeans.loop_program``), compiled by the driver: ``kmeans_step``
    launched 40 times, all on ``kms_tc``, with the launch counts set to 0
    just before and read just after; its centroids the bits of five calls of
    the one-step program.  Then ``cf.Cond`` (both branches), ``cf.Call`` and
    ``df.Source → df.Collect`` on the card against the CPU."""
    import numpy as np
    import torch

    from repro_torch import kmeans
    from repro_torch.compiler import compile as cvm_compile
    from repro_torch.convert import tensors_from_arrays
    from repro_torch.kernels import ops

    d, k, steps = KMEANS_D, KMEANS_K, 5
    x, c0 = kmeans.make_data(n, d, k, KMEANS_SEED)
    X, C = tensors_from_arrays(x, c0, device=dev)
    loop = cvm_compile(kmeans.loop_program(n, d, k, steps, KMEANS_PARALLEL), device=dev,
                       cache=False)
    one = cvm_compile(kmeans.loop_program(n, d, k, 1, KMEANS_PARALLEL), device=dev, cache=False)
    ops.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    (looped,) = loop({"X": X}, C)
    sync(dev)
    loop_ms = (time.perf_counter() - t0) * 1e3
    launches, routes = ops.LAUNCHES["kmeans_step"], dict(ops.KMEANS_LAUNCHES)
    expect = steps * KMEANS_PARALLEL
    if launches != expect or routes != {"kms_tc": expect, "kms_main": 0}:
        raise AssertionError(f"cf.Loop k-means: {launches} launches, routes {routes}")
    stepped = C
    t0 = time.perf_counter()
    for _ in range(steps):
        (stepped,) = one({"X": X}, stepped)
    sync(dev)
    step_ms = (time.perf_counter() - t0) * 1e3
    if (looped.shape != (k, d) or not bool(torch.isfinite(looped).all())
            or looped.cpu().numpy().tobytes() != stepped.cpu().numpy().tobytes()):
        raise AssertionError("cf.Loop k-means: centroids differ from five one-step calls")
    if loop.degraded or one.degraded:
        raise AssertionError("cf.Loop k-means: degraded")
    log(f"cf.Loop k-means n={n} d={d} k={k}, {steps} iterations: kmeans_step launched "
        f"{launches} times, routes {json.dumps(routes)}; centroids the bits of {steps} "
        f"one-step calls; loop {loop_ms:.3f} ms, stepped {step_ms:.3f} ms (host clock)")

    rng = np.random.default_rng(1)
    xs, ys = (rng.normal(size=(1024, 8)).astype(np.float32) for _ in range(2))
    cond, call, source = control_flow_programs()
    cases = [("cf.Cond then", cond, {}, [np.array(True), xs, ys]),
             ("cf.Cond else", cond, {}, [np.array(False), xs, ys]),
             ("cf.Call", call, {}, [xs, ys]),
             ("df.Source → df.Collect", source, {"t": xs}, [])]
    for what, prog, srcs, args in cases:
        got = cvm_compile(prog, device=dev, cache=False)(srcs, *args)
        want = cvm_compile(prog, device="cpu", cache=False)(srcs, *args)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=KERNEL_RTOL,
                                       atol=1e-5, err_msg=what)
    log("control flow on the card: " + ", ".join(c[0] for c in cases) + " match the CPU")


# ---------------------------------------------------------------------------
# the spmd and multipod targets: four ranks sharing the card over gloo
# ---------------------------------------------------------------------------

#: rank processes of the spmd phase; all compute on cuda:0 (one card)
SPMD_RANKS = 4
#: the gloo group's timeout: a rank that faults fails the phase, not hangs it
SPMD_GROUP_TIMEOUT_S = 120
#: how long the parent waits for the ranks
SPMD_JOIN_S = 600
#: the collective plans against the local run at parallel=4 (the ranks'
#: partials added in gloo's order)
SPMD_RTOL = 1e-5
#: the elastic executor's worker counts; the return to 4 must be a plan-cache hit
SPMD_ELASTIC = (4, 2, 4)
#: the grouped queries run again under grouped-recombine=exchange
SPMD_EXCHANGE = ("q1", "q4")
#: timed calls of each compiled spmd plan (the median is reported)
SPMD_REPS = 5


def _gloo_probe(world: int) -> dict:
    """Which collectives this gloo group runs on CUDA tensors (f32, i32 and
    bool; min and max too for all_reduce; bf16 for all_reduce and the two
    collectives DTensor issues, all_gather_into_tensor and
    reduce_scatter_tensor, whose results are checked): ``"ok"`` or the
    error.  A refusal raises on every rank before any byte moves."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for op in ("all_reduce", "all_gather", "all_to_all", "broadcast", "all_gather_into_tensor",
               "reduce_scatter_tensor"):
        for dt in (torch.float32, torch.int32, torch.bool, torch.bfloat16):
            t = (torch.arange(4 * world, device=dev) % 2).to(dt)
            try:
                if dt == torch.bfloat16 and op not in ("all_reduce", "all_gather_into_tensor",
                                                       "reduce_scatter_tensor"):
                    continue  # the sharded step's collectives carry bf16
                if op == "all_reduce":
                    if dt == torch.bool:
                        continue
                    for red in (dist.ReduceOp.SUM, dist.ReduceOp.MIN, dist.ReduceOp.MAX):
                        dist.all_reduce(t.clone(), op=red)
                elif op == "all_gather":
                    dist.all_gather([torch.empty_like(t) for _ in range(world)], t)
                elif op == "all_to_all":
                    dist.all_to_all_single(torch.empty_like(t), t)
                elif op == "all_gather_into_tensor":
                    got = torch.empty(world * t.numel(), device=dev, dtype=dt)
                    dist.all_gather_into_tensor(got, t)
                    if not torch.equal(got.view(world, -1), t.expand(world, -1)):
                        raise RuntimeError(f"all_gather_into_tensor gave {got.tolist()}")
                elif op == "reduce_scatter_tensor":
                    if dt == torch.bool:
                        continue
                    got = torch.empty(t.numel() // world, device=dev, dtype=dt)
                    dist.reduce_scatter_tensor(got, t)
                    want = (t.view(world, -1)[dist.get_rank()] * world).to(dt)
                    if not torch.equal(got, want):
                        raise RuntimeError(f"reduce_scatter_tensor gave {got.tolist()}")
                else:
                    dist.broadcast(t.clone(), src=0)
                torch.cuda.synchronize()
            except RuntimeError as e:  # the probe's answer, not a fallback
                out[op] = f"{type(e).__name__}: {str(e)[:200]}"
            dist.barrier()
        out.setdefault(op, "ok")
    return out


def _spmd_rank(rank: int, world: int, workdir: str) -> None:
    """One rank of ``phase_spmd`` (a spawned process): every case on the
    same full tables; its answers, counts and times go to rank<r>.pkl."""
    import datetime
    import os
    import pickle

    sys.path.insert(0, str(ROOT / "src"))
    os.environ["LOCAL_RANK"] = str(rank)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=SPMD_GROUP_TIMEOUT_S))
    try:
        out = _spmd_cases(rank, world, Path(workdir))
        with open(Path(workdir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _spmd_cases(rank: int, world: int, workdir: Path) -> dict:
    import warnings

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import kmeans
    from repro_torch.backends import spmd
    from repro_torch.backends.multipod import ElasticExecutor
    from repro_torch.compiler import PlanCache
    from repro_torch.frontends.dataflow import _to_numpy
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs import DegradedWarning
    from repro_torch.relational import tpch
    from repro_torch.robust.inject import inject

    warnings.simplefilter("error", DegradedWarning)
    # the tables are read-only maps of the parent's files; each is copied
    # onto the card once
    warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    out = {"probe": _gloo_probe(world)}
    columns = json.loads((workdir / "columns.json").read_text())
    tables = {t: {c: np.load(workdir / f"{t}.{c}.npy", mmap_mode="r") for c in cols}
              for t, cols in columns.items()}
    ctx = tpch.make_context(tables)
    ctx.statistics()
    mesh = make_mesh((world,), ("workers",))
    srcs = ctx.sources(mesh.device)
    frames = {q: f(ctx) for q, f in tpch.QUERIES.items()}
    torch.cuda.synchronize()
    dist.barrier()
    out["device"] = str(mesh.device)
    out["setup_s"] = time.perf_counter() - t_start

    def run(frame, **kw):
        return frame.collect(device="cuda", target="spmd", parallel=world, **kw)

    # the main path: the six queries, the counts set to 0 just before and
    # read just after; spmd.SIZES goes on recording the collectives'
    # sizes through the exchange and k-means cases
    with recording(TPCH_KERNELS) as captured:
        ops.reset_launches()
        spmd.reset_calls()
        res, routes, per_query, calls = {}, {}, {}, {}
        for q, frame in frames.items():
            before, called = dict(ops.LAUNCHES), dict(spmd.CALLS)
            res[q], routes[q] = routed(run, frame)
            per_query[q] = {k: ops.LAUNCHES[k] - before[k] for k in before}
            calls[q] = {k: n - called.get(k, 0) for k, n in spmd.CALLS.items()
                        if n != called.get(k, 0)}
        out.update(default=res, routes=routes, per_query=per_query, calls=calls,
                   launches=dict(ops.LAUNCHES), gen_launches=dict(ops.GEN_LAUNCHES))
    t_main = time.perf_counter()
    out["nocoll"] = {q: run(f, collectives=False) for q, f in frames.items()}
    out["exchange"], out["exchange_calls"] = {}, {}
    with recording(TPCH_KERNELS) as captured_x:
        for q in SPMD_EXCHANGE:
            called = dict(spmd.CALLS)
            out["exchange"][q] = routed(run, frames[q],
                                        strategy={"grouped-recombine": "exchange"})
            out["exchange_calls"][q] = {k: n - called.get(k, 0)
                                        for k, n in spmd.CALLS.items()
                                        if n != called.get(k, 0)}
    plan = ctx.compile(frames["q4"], target="spmd", parallel=world, device="cuda",
                       optimize="cost", cache=PlanCache())
    out["cost"] = {"strategy": dict(plan.strategy), "candidates": len(plan.decision.candidates),
                   "result": _to_numpy(plan(srcs)[0])}

    ex = ElasticExecutor(program_builder=lambda: frames["q6"].program("q6"),
                         catalog=ctx.catalog(), cache=PlanCache())
    out["elastic"] = []
    for workers in SPMD_ELASTIC:
        ex.on_resize(workers)
        got = ex.run(srcs)
        out["elastic"].append({"workers": workers, "target": ex._current[1].target,
                               "hit": ex._current[1].cache_hit,
                               "result": _to_numpy(got[0])})

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with inject("spmd.shard", times=1):
            plan = ctx.compile(frames["q6"], target="spmd", parallel=world, device="cuda",
                               cache=PlanCache())
            got = plan(srcs)
    out["fault"] = {"degraded": list(plan.degraded), "result": _to_numpy(got[0]),
                    "warned": sum(issubclass(w.category, DegradedWarning) for w in caught)}

    x = torch.from_numpy(np.load(workdir / "kmeans_x.npy")).to(mesh.device)
    c = torch.from_numpy(np.load(workdir / "kmeans_c.npy")).to(mesh.device)
    step = spmd.SpmdBackend(mesh).compile(
        kmeans.program(KMEANS_N, KMEANS_D, KMEANS_K, parallel=world))
    ops.reset_launches()
    sums, counts = step({}, x, c)
    out["kmeans"] = {"sums": sums.cpu().numpy(), "counts": counts.cpu().numpy(),
                     "launches": ops.LAUNCHES["kmeans_step"],
                     "routes": dict(ops.KMEANS_LAUNCHES)}
    del x, c
    sizes = list(spmd.SIZES)

    # per query: the median of SPMD_REPS calls of the compiled plan, the
    # card synchronised on every rank, then a barrier
    out["ms"] = {}
    for q, frame in frames.items():
        plan = ctx.compile(frame, target="spmd", parallel=world, device="cuda")
        plan(srcs)
        times = []
        for _ in range(SPMD_REPS):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            plan(srcs)
            torch.cuda.synchronize()
            dist.barrier()
            times.append((time.perf_counter() - t0) * 1e3)
        out["ms"][q] = statistics.median(times)

    # each collective at the sizes the queries, the exchange and the k-means
    # step gave it, once per (op, bytes): the median of 5, the card
    # synchronised before each, a barrier between
    comm = spmd.Collectives(mesh)
    timed, out["collective_ms"] = set(), []
    for op, shape, dtype, nbytes in sizes:
        if (op, nbytes) in timed:
            continue
        timed.add((op, nbytes))
        t = torch.zeros(shape, dtype=getattr(torch, dtype), device=mesh.device)
        fn = {"all_reduce": lambda: comm.all_reduce(t, "sum"),
              "all_gather": lambda: comm.all_gather(t),
              "all_to_all": lambda: comm.all_to_all(t),
              "broadcast": lambda: comm.broadcast(t, 0)}[op]
        fn()
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out["collective_ms"].append({"op": op, "shape": list(shape), "dtype": dtype,
                                     "bytes": nbytes, "ms": statistics.median(times)})
    out["cases_s"] = time.perf_counter() - t_main
    dist.barrier()

    # after the last collective: each kernel call of the path and of the
    # exchange runs against its plain version (replays, not counted)
    if rank == 0:
        worst = {}
        for i, (name, args, kw) in enumerate(captured + captured_x):
            err = compare_outputs(f"spmd {name}#{i}", getattr(ops, name)(*args, **kw),
                                  getattr(ref, name)(*args, **kw))
            worst[name] = max(worst.get(name, 0.0), err)
        out["replayed"] = {"calls": len(captured) + len(captured_x), "max_abs_err": worst}
    out["rank_s"] = time.perf_counter() - t_start
    return out


def _digest(result: dict) -> str:
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for k in sorted(result):
        a = np.ascontiguousarray(result[k])
        h.update(k.encode() + str(a.dtype).encode() + a.tobytes())
    return h.hexdigest()


def _close_to(what: str, got, want, rtol: float, keys=()) -> None:
    """Integers exact, floats within ``rtol``, after ordering by ``keys``."""
    import numpy as np

    def order(d):
        d = {k: np.asarray(v).ravel() for k, v in d.items()}
        if not keys:
            return d
        o = np.lexsort([d[k] for k in reversed(keys)])
        return {k: v[o] for k, v in d.items()}

    got, want = order(got), order(want)
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{what}.{k}: {g.dtype}{g.shape} vs {w.dtype}{w.shape}")
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=f"{what}.{k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}.{k}")


def phase_spmd(tables, frames, reps: int, pool, smi: str) -> dict:
    """The spmd and multipod targets: SPMD_RANKS rank processes (spawned)
    sharing the card over a gloo group, each running the six queries with
    ``target="spmd"`` and ``parallel=4`` (its kernels launched on its
    chunk), then ``collectives=False``, Q1 and Q4 under the exchange, Q4
    costed, Q6 through ``ElasticExecutor`` at 4 → 2 → 4 workers, Q6 under
    an injected ``spmd.shard`` fault, and a k-means step.  Each answer is
    held against numpy, the local run at ``parallel=4`` and the other
    ranks'; each rank's launches against their routes.  Returns the ranks'
    launches, to be added to the kernels line."""
    import pickle
    import tempfile

    import numpy as np
    import torch.multiprocessing as mp

    from repro_torch import kmeans
    from repro_torch.backends import spmd
    from repro_torch.backends.local import LocalBackend
    from repro_torch.relational import tpch

    t_phase = time.perf_counter()
    label = f"{SPMD_RANKS} ranks on one {smi}, gloo"
    local, local_ms = {}, {}
    for q, frame in frames.items():
        local[q] = frame.collect(device="cuda", parallel=SPMD_RANKS)
        plan = frame._ctx.compile(frame, parallel=SPMD_RANKS, device="cuda")
        srcs = frame._ctx.sources("cuda")
        local_ms[q] = run_ms(lambda: plan(srcs), "cuda", reps)
    x, c = kmeans.make_data(KMEANS_N, KMEANS_D, KMEANS_K, KMEANS_SEED)
    local_step = LocalBackend(use_kernels=True, device="cuda").compile(
        kmeans.program(KMEANS_N, KMEANS_D, KMEANS_K, parallel=SPMD_RANKS))({}, x, c)

    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        for t, cols in tables.items():
            for name, v in cols.items():
                np.save(work / f"{t}.{name}.npy", v)
        (work / "columns.json").write_text(json.dumps({t: list(cols) for t, cols in tables.items()}))
        np.save(work / "kmeans_x.npy", x)
        np.save(work / "kmeans_c.npy", c)
        spawn = mp.get_context("spawn")
        procs = [spawn.Process(target=_spmd_rank, args=(r, SPMD_RANKS, tmp))
                 for r in range(SPMD_RANKS)]
        t_ranks = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + SPMD_JOIN_S
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        codes = [p.exitcode for p in procs]
        if hung or any(codes):
            raise AssertionError(f"spmd ranks exited {codes} ({len(hung)} killed)")
        ranks_s = time.perf_counter() - t_ranks
        ranks = [pickle.loads((work / f"rank{r}.pkl").read_bytes()) for r in range(SPMD_RANKS)]
    r0 = ranks[0]

    refused = sorted(op for op, ok in r0["probe"].items() if ok != "ok")
    if refused:
        raise AssertionError(f"gloo refuses {refused} on CUDA tensors, which backends/spmd.py "
                             f"and DTensor (the sharded train step) hand it as they are: "
                             f"{r0['probe']}")
    log(f"spmd ({label}): gloo runs every collective on CUDA tensors "
        f"{json.dumps(r0['probe'])}; host-staged by the backend: none (gloo copies "
        "through the host itself)")

    digests = set()
    for r, rk in enumerate(ranks):
        if rk["device"] != "cuda:0":
            raise AssertionError(f"rank {r} computed on {rk['device']}")
        for q in frames:
            want = tpch.REFERENCES[q](tables)
            check_query(f"spmd {q} rank {r}", rk["default"][q], want)
            _close_to(f"spmd {q} rank {r} vs local", rk["default"][q], local[q], SPMD_RTOL,
                      GROUP_KEYS.get(q, ()))
            for k, v in local[q].items():  # folded in rank order: local's bits
                if not np.array_equal(np.asarray(rk["nocoll"][q][k]), np.asarray(v)):
                    raise AssertionError(f"spmd {q} collectives=False rank {r}: {k} differs "
                                         "from local parallel=4")
        for q, (got, took) in rk["exchange"].items():
            check_query(f"spmd {q} exchange rank {r}", got, tpch.REFERENCES[q](tables))
            _close_to(f"spmd {q} exchange rank {r} vs local", got, local[q], SPMD_RTOL,
                      GROUP_KEYS.get(q, ()))
            if "gsa_reg" not in took and "gsa_smem" not in took and "gsa_global" not in took:
                raise AssertionError(f"spmd {q} exchange rank {r} ran no grouped kernel: {took}")
        check_routes(f"spmd rank {r}", rk["launches"], rk["gen_launches"], rk["routes"])
        for kname, queries in EXPECTED.items():
            for q in queries:
                if rk["per_query"][q][kname] < 1:
                    raise AssertionError(f"spmd rank {r}: {q} did not launch {kname}")
        digests.add(_digest({f"{part}/{q}/{k}": v for part in ("default", "nocoll")
                             for q, d in rk[part].items() for k, v in d.items()}))
        for e in rk["elastic"]:
            check_query(f"elastic q6 at {e['workers']} rank {r}", e["result"],
                        tpch.REFERENCES["q6"](tables))
        if [(e["target"], e["hit"]) for e in rk["elastic"]] != [
                ("multipod", False), ("multipod", False), ("multipod", True)]:
            raise AssertionError(f"elastic rank {r}: {rk['elastic']}")
        if not rk["fault"]["degraded"] or rk["fault"]["warned"] < 1:
            raise AssertionError(f"spmd.shard rank {r}: {rk['fault']}")
        check_query(f"spmd q6 after spmd.shard rank {r}", rk["fault"]["result"],
                    tpch.REFERENCES["q6"](tables))
        check_query(f"spmd q4 costed rank {r}", rk["cost"]["result"], tpch.REFERENCES["q4"](tables))
        if rk["kmeans"]["routes"]["kms_tc"] != rk["kmeans"]["launches"] or not rk["kmeans"]["launches"]:
            raise AssertionError(f"spmd k-means rank {r}: {rk['kmeans']}")
    if len(digests) != 1:
        raise AssertionError(f"the ranks' answers differ: {digests}")
    ref = kmeans.reference_step(x, c, pool.map)
    for r, rk in enumerate(ranks):
        kmeans.check_step(f"spmd k-means step rank {r}", (rk["kmeans"]["sums"],
                          rk["kmeans"]["counts"]), local_step, ref, STEP_RTOL)
    launches = {k: sum(rk["launches"][k] for rk in ranks) for k in TPCH_KERNELS}
    launches["kmeans_step"] = sum(rk["kmeans"]["launches"] for rk in ranks)
    log(f"spmd ({label}): six queries on every rank match numpy, the local run at "
        f"parallel={SPMD_RANKS} (rtol {SPMD_RTOL}) and each other (one digest); "
        f"collectives=False gives the local run's bits; Q1/Q4 under the exchange, Q4 costed "
        f"({r0['cost']['strategy']} of {r0['cost']['candidates']}), Q6 elastic "
        f"{[(e['workers'], e['target'], e['hit']) for e in r0['elastic']]}, Q6 after "
        f"spmd.shard via {r0['fault']['degraded']} and the k-means step (tie-margin rule "
        f"against the local step) hold")
    log(f"spmd ({label}): launches per rank {json.dumps([rk['launches'] for rk in ranks])}; "
        f"routes {json.dumps(r0['routes'])}; k-means {launches['kmeans_step']} launches on "
        f"kms_tc; rank 0 replayed {r0['replayed']['calls']} kernel calls against their plain "
        f"versions, max abs error {json.dumps(r0['replayed']['max_abs_err'])}")
    for q in frames:
        log(f"spmd {q} ({label}): median {r0['ms'][q]:.3f} ms over {SPMD_REPS} calls of the "
            f"compiled plan (rank 0; ranks {[round(rk['ms'][q], 3) for rk in ranks]}); local "
            f"parallel={SPMD_RANKS} {local_ms[q]:.3f} ms on the card alone; collectives a call "
            f"{json.dumps(r0['calls'][q])}")
    for q, called in r0["exchange_calls"].items():
        log(f"spmd {q} under grouped-recombine=exchange ({label}): collectives a call "
            f"{json.dumps(called)}")
    by_op = {op: [] for op in spmd.OPS}
    for row in r0["collective_ms"]:
        by_op[row["op"]].append(row)
    for op, rows in by_op.items():
        rows.sort(key=lambda row: row["bytes"])
        log(f"spmd collective {op} ({label}; median of 5 at each size the queries, the "
            f"exchange and the k-means step gave it): " + ("; ".join(
                f"{row['bytes']} B {row['dtype']}{tuple(row['shape'])} {row['ms']:.3f} ms"
                for row in rows) or "issued by none of them"))
    summary = {"label": label, "ms": {q: r0["ms"][q] for q in frames}, "local_ms": local_ms,
               "calls": r0["calls"], "exchange_calls": r0["exchange_calls"],
               "collective_ms": r0["collective_ms"],
               "host_staged": [],
               "setup_s": [rk["setup_s"] for rk in ranks],
               "cases_s": [rk["cases_s"] for rk in ranks], "ranks_s": ranks_s,
               "phase_s": time.perf_counter() - t_phase}
    log("spmd: " + json.dumps(summary))
    log(f"spmd phase took {summary['phase_s']:.1f} s (ranks {ranks_s:.1f} s: set-up "
        f"{max(summary['setup_s']):.1f} s, cases {max(summary['cases_s']):.1f} s)")
    return launches


# ---------------------------------------------------------------------------
# the sharded train step: Qwen2-1.5B's widths over a 2 × 2 mesh of four
# gloo ranks sharing the card, beside its dry-run
# ---------------------------------------------------------------------------


def _sharded_rank(rank: int, world: int, workdir: str) -> None:
    """One rank of ``phase_sharded_train`` (a spawned process): its
    numbers go to rank<r>.pkl."""
    import datetime
    import os
    import pickle

    sys.path.insert(0, str(ROOT / "src"))
    os.environ["LOCAL_RANK"] = str(rank)
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 products, as main() sets
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=SPMD_GROUP_TIMEOUT_S * 2))
    try:
        out = _sharded_cases(rank)
        with open(Path(workdir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _sharded_cases(rank: int) -> dict:
    from dataclasses import replace

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.frontends.tensor import lower_to_pjit, plan_train_program
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding as shd
    from repro_torch.models.api import build_model, make_train_step
    from repro_torch.train.optimizer import AdamW, Optimizer, tree_leaves

    mesh = make_mesh(SHARDED_MESH, ("data", "model"), device="cuda")
    base = get_config(SERVE_ARCH)
    got = TokenPipeline(vocab=base.vocab, seq_len=TRAIN_S, global_batch=TRAIN_B, seed=0).batch_at(0)
    batch = {k: torch.from_numpy(v).to(mesh.device) for k, v in got.items()}
    grads_of = Optimizer(lambda p: {}, lambda g, st, p: (g, st))
    out = {"device": str(mesh.device), "probe": _gloo_probe(dist.get_world_size())}
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        model = build_model(replace(base, n_layers=SHARDED_DEPTH, dtype=dtype))
        params = model.init(torch.Generator(mesh.device).manual_seed(0))
        plan = plan_train_program(model, n_data=SHARDED_MESH[0])
        opt = AdamW(lr=TRAIN_LR)
        rec: dict = {}
        if dtype == "float32":
            # the one-device step on rank 0 (the others wait), then the sharded
            # step's gradients, each leaf assembled on every rank
            if rank == 0:
                one, _ = make_train_step(model, grads_of, microbatch=SHARDED_MICRO)
                ref_g, _, ref_met = one(params, {}, batch)
                one, _ = make_train_step(model, opt, microbatch=SHARDED_MICRO)
                ref_p, _, _ = one(params, opt.init(params), batch)
                torch.cuda.synchronize()
                t0 = time.perf_counter()  # a second one-device step, timed: the card alone
                one(params, opt.init(params), batch)
                torch.cuda.synchronize()
                rec["one_device_step_s"] = time.perf_counter() - t0
            dist.barrier()
            step, _ = lower_to_pjit(plan, model, mesh, grads_of, batch_shapes=batch,
                                    microbatch=SHARDED_MICRO)
            g, _, met = step(*step.place(params, {}, batch))
            rec["grads_loss"] = float(met["loss"])
            gaps = []
            for a, b in zip(tree_leaves(g), tree_leaves(ref_g) if rank == 0 else tree_leaves(g)):
                full = a.full_tensor()
                if rank == 0:
                    gaps.append(_rel_gap(full, b))
            if rank == 0:
                rec["one_device_loss"] = float(ref_met["loss"])
                rec["grad_rel"] = gaps
                del ref_g
            del g
        step, _ = lower_to_pjit(plan, model, mesh, opt, batch_shapes=batch,
                                microbatch=SHARDED_MICRO)
        p, s, b = step.place(params, opt.init(params), batch)
        rec["local_gb"] = sum(_bytes(t.to_local()) for t in tree_leaves((p, s))) / 1e9
        torch.cuda.synchronize()
        rec["setup_s"] = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        dist.barrier()
        t0 = time.perf_counter()
        with shd.comm_bytes() as comm:  # the warm-up step, its collectives counted
            p, s, met = step(p, s, b)
        torch.cuda.synchronize()
        rec["warmup_s"] = time.perf_counter() - t0
        rec["comm"] = comm.by_kind()
        rec["records"] = [(r["kind"], r["shape"], r["dtype"], r["bytes"]) for r in comm.records]
        losses = [float(met["loss"])]
        if dtype == "float32":
            upd = []
            for a, b0, b1 in zip(tree_leaves(p), tree_leaves(params),
                                 tree_leaves(ref_p) if rank == 0 else tree_leaves(p)):
                full = a.full_tensor()
                if rank == 0:
                    u = (b1.double() - b0.double()).cpu()
                    d = (full.double() - b1.double()).cpu()
                    bound = (SHARDED_UPD_RTOL * float(u.norm())
                             + SHARDED_UPD_ATOL * TRAIN_LR * math.sqrt(u.numel()))
                    upd.append((float(d.norm()), bound))
            if rank == 0:
                rec["update"] = upd
                del ref_p
        del params
        times = []
        for _ in range(SHARDED_STEPS):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            p, s, met = step(p, s, b)
            losses.append(float(met["loss"]))  # the loss is a plain tensor: this waits
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        rec["launches"] = {k: v for k, v in ops.LAUNCHES.items() if v}
        rec["losses"] = losses
        rec["step_s"] = times
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rec["finite"] = all(bool(torch.isfinite(t.to_local()).all()) for t in tree_leaves(p))
        out[dtype] = rec
        del p, s, b, step
        torch.cuda.empty_cache()
    del batch
    out["moe"] = _sharded_moe_case(rank, mesh)
    out["hybrid"] = _sharded_hybrid_case(rank, mesh)
    return out


def _sharded_moe_case(rank: int, mesh) -> dict:
    """Moonlight-16B-A3B's widths at SHARDED_MOE_DEPTH layers in f32 over
    the mesh (``sharding.per_rank_moe``): the gradients' step against the
    one-device step on rank 0 with the dropped choices counted on both,
    then a warm-up AdamW step (its collectives counted) and
    SHARDED_MOE_STEPS timed ones."""
    from dataclasses import replace

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.frontends.tensor import lower_to_pjit, plan_train_program
    from repro_torch.kernels import ops
    from repro_torch.models import sharding as shd
    from repro_torch.models.api import build_model, make_train_step
    from repro_torch.train.optimizer import AdamW, Optimizer, tree_leaves

    cfg = replace(get_config(MOE_ARCH), n_layers=SHARDED_MOE_DEPTH, dtype="float32")
    got = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_S, global_batch=TRAIN_B, seed=0).batch_at(0)
    batch = {k: torch.from_numpy(v).to(mesh.device) for k, v in got.items()}
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(mesh.device).manual_seed(0))
    plan = plan_train_program(model, n_data=SHARDED_MESH[0])
    grads_of = Optimizer(lambda p: {}, lambda g, st, p: (g, st))
    rec: dict = {}
    if rank == 0:
        one, _ = make_train_step(model, grads_of, microbatch=SHARDED_MICRO)
        with routing() as r:
            ref_g, _, ref_met = one(params, {}, batch)
        rec["one_device_drops"] = _dropped(r)
        rec["one_device_loss"] = float(ref_met["loss"])
        del r, one
    dist.barrier()
    step, _ = lower_to_pjit(plan, model, mesh, grads_of, batch_shapes=batch,
                            microbatch=SHARDED_MICRO)
    with routing() as r:
        g, _, met = step(*step.place(params, {}, batch))
    rec["drops"] = _dropped(r)
    del r
    rec["grads_loss"] = float(met["loss"])
    gaps = []
    for a, b in zip(tree_leaves(g), tree_leaves(ref_g) if rank == 0 else tree_leaves(g)):
        full = a.full_tensor()
        if rank == 0:
            gaps.append(_rel_gap(full, b))
    rec["grad_rel"] = gaps
    del g
    if rank == 0:
        del ref_g
    opt = AdamW(lr=TRAIN_LR)
    step, _ = lower_to_pjit(plan, model, mesh, opt, batch_shapes=batch, microbatch=SHARDED_MICRO)
    p, s, b = step.place(params, opt.init(params), batch)
    del params
    torch.cuda.synchronize()
    rec["setup_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    dist.barrier()
    t0 = time.perf_counter()
    with shd.comm_bytes() as comm:
        p, s, met = step(p, s, b)
    torch.cuda.synchronize()
    rec["warmup_s"] = time.perf_counter() - t0
    rec["comm"] = comm.by_kind()
    losses = [float(met["loss"])]
    times = []
    for _ in range(SHARDED_MOE_STEPS):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        p, s, met = step(p, s, b)
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rec["launches"] = {k: v for k, v in ops.LAUNCHES.items() if v}
    rec["losses"] = losses
    rec["step_s"] = times
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["finite"] = all(bool(torch.isfinite(t.to_local()).all()) for t in tree_leaves(p))
    del p, s, b, step
    torch.cuda.empty_cache()
    return rec


def _sharded_hybrid_case(rank: int, mesh) -> dict:
    """Zamba2-7B's widths at SHARDED_HYBRID_DEPTH layers over the mesh, the
    Mamba2 mixer per rank (``sharding.per_rank_mamba``): the f32 gradients'
    step against the one-device f32 and f64 steps on rank 0; a warm-up bf16
    AdamW step (its collectives counted) and SHARDED_HYBRID_STEPS timed
    ones; then the bf16 prefill with attn_mode="pallas" over the mesh (the
    launches counted from 0 just before it; its first flash_attention
    call's local inputs recorded and the kernel held to its plain version
    on them, rank 0's inputs returned for phase_kernels) and
    SHARDED_DECODE_STEPS decode steps, beside the one-device bf16 run and
    its f32 twin (the noise floor) on rank 0."""
    from dataclasses import replace

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.frontends.tensor import lower_to_pjit, plan_train_program
    from repro_torch.kernels import ops, ref
    from repro_torch.models import sharding as shd
    from repro_torch.models.api import build_model, make_train_step
    from repro_torch.train.optimizer import AdamW, Optimizer, tree_leaves, tree_map

    base = replace(get_config(ZAMBA_ARCH), n_layers=SHARDED_HYBRID_DEPTH)
    got = TokenPipeline(vocab=base.vocab, seq_len=TRAIN_S, global_batch=TRAIN_B, seed=0).batch_at(0)
    batch = {k: torch.from_numpy(v).to(mesh.device) for k, v in got.items()}
    grads_of = Optimizer(lambda p: {}, lambda g, st, p: (g, st))
    rec: dict = {}
    t0 = time.perf_counter()
    # 1. f32: the sharded gradients against one device's, in f32 and f64
    model = build_model(replace(base, dtype="float32"))
    params = model.init(torch.Generator(mesh.device).manual_seed(0))
    plan = plan_train_program(model, n_data=SHARDED_MESH[0])
    if rank == 0:
        one, _ = make_train_step(model, grads_of, microbatch=SHARDED_MICRO)
        ref_g, _, ref_met = one(params, {}, batch)
        model64 = build_model(replace(base, dtype="float64"))
        one64, _ = make_train_step(model64, grads_of, microbatch=SHARDED_MICRO)
        g64, _, met64 = one64(tree_map(lambda t: t.double(), params), {}, batch)
        rec["witness"] = [_rel_gap(a, b) for a, b in zip(tree_leaves(ref_g), tree_leaves(g64))]
        rec["one_device_loss"], rec["one_device_f64_loss"] = (float(ref_met["loss"]),
                                                              float(met64["loss"]))
        del one64, g64, model64
        torch.cuda.empty_cache()
    dist.barrier()
    step, _ = lower_to_pjit(plan, model, mesh, grads_of, batch_shapes=batch,
                            microbatch=SHARDED_MICRO)
    g, _, met = step(*step.place(params, {}, batch))
    rec["grads_loss"] = float(met["loss"])
    gaps = []
    for a, b in zip(tree_leaves(g), tree_leaves(ref_g) if rank == 0 else tree_leaves(g)):
        full = a.full_tensor()
        if rank == 0:
            gaps.append(_rel_gap(full, b))
    rec["grad_rel"] = gaps
    del g, params, step
    if rank == 0:
        del ref_g
    torch.cuda.empty_cache()
    rec["check_s"] = time.perf_counter() - t0
    # 2. bf16: a warm-up AdamW step and timed ones
    model = build_model(base)
    params = model.init(torch.Generator(mesh.device).manual_seed(0))
    opt = AdamW(lr=TRAIN_LR)
    step, _ = lower_to_pjit(plan_train_program(model, n_data=SHARDED_MESH[0]), model, mesh, opt,
                            batch_shapes=batch, microbatch=SHARDED_MICRO)
    dm = step.device_mesh
    p, s, b = step.place(params, opt.init(params), batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    dist.barrier()
    t0 = time.perf_counter()
    with shd.comm_bytes() as comm:
        p, s, met = step(p, s, b)
    torch.cuda.synchronize()
    rec["warmup_s"] = time.perf_counter() - t0
    rec["comm"] = comm.by_kind()
    losses, times = [float(met["loss"])], []
    for _ in range(SHARDED_HYBRID_STEPS):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        p, s, met = step(p, s, b)
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rec["train_launches"] = {k: v for k, v in ops.LAUNCHES.items() if v}
    rec["losses"], rec["step_s"] = losses, times
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["finite"] = all(bool(torch.isfinite(t.to_local()).all()) for t in tree_leaves(p))
    del p, s, b, step, batch
    torch.cuda.empty_cache()
    # 3. the bf16 prefill over the mesh through flash_attention, then decode
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, base.vocab, (TRAIN_B, TRAIN_S))).to(mesh.device)
    fed = [torch.from_numpy(rng.integers(0, base.vocab, (TRAIN_B, 1))).to(mesh.device)
           for _ in range(SHARDED_DECODE_STEPS)]

    def serve(m, prm, place=lambda t: t):
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = m.prefill(prm, {"tokens": place(tokens)}, TRAIN_S + len(fed))
        out.append(logits.full_tensor() if hasattr(logits, "full_tensor") else logits)
        torch.cuda.synchronize()
        pre = time.perf_counter() - t0
        for tok in fed:
            logits, state = m.decode(prm, state, place(tok))
            out.append(logits.full_tensor() if hasattr(logits, "full_tensor") else logits)
        return out, pre, state

    model = build_model(replace(base, attn_mode="pallas"))
    pp = shd.shard_tree(params, shd.tree_param_specs(params, mesh), dm)

    def place(t):
        return shd.shard_tree({"tokens": t}, shd.batch_specs({"tokens": (t.shape, t.dtype)},
                                                              mesh), dm)["tokens"]

    with torch.no_grad(), shd.dtensor_scope(pp):
        serve(model, pp, place)  # warm-up
        dist.barrier()
        ops.reset_launches()
        with recording(["flash_attention"], keep=lambda i: i == 0) as calls:
            sharded, pre_s, state = serve(model, pp, place)
        rec["serve_launches"] = {k: v for k, v in ops.LAUNCHES.items() if v}
        # the first call's local q, k, v (this rank's sequences and heads)
        # against the plain version; rank 0's go on to phase_kernels
        _, args, kw = calls[0]
        err, share = check_attention(f"sharded hybrid prefill: rank {rank}'s flash_attention",
                                     ops.flash_attention(*args, **kw),
                                     ref.flash_attention(*args, **kw), args[2])
        rec["fa_check"] = {"shape": list(args[0].shape), "max_abs_err": err,
                           "bound_share": share}
        if rank == 0:
            rec["fa_call"] = ("flash_attention", tuple(a.cpu() for a in args), kw)
        rec["state_placements"] = {k: [str(q) for q in state[k].placements]
                                   for k in ("conv", "ssm", "k", "v")}
        want = shd.cache_specs({k: state[k] for k in ("conv", "ssm", "k", "v")}, mesh, base)
        rec["cache_specs"] = {k: [str(q) for q in shd.placements(dm, spec)]
                              for k, spec in want.items()}
    rec["prefill_ms"] = pre_s * 1e3
    rec["local_heads"] = base.n_heads // SHARDED_MESH[1]
    if rank == 0:  # one device: the same run, and in f32 the witness of bf16's rounding
        with torch.no_grad():
            one, one_s, _ = serve(model, params)
            exact, _, _ = serve(build_model(replace(base, dtype="float32")),
                                tree_map(lambda t: t.float(), params))
        def rms(got):
            return math.sqrt(sum(float(((a.double() - b.double()) ** 2).sum())
                                 for a, b in zip(got, exact)) / sum(b.numel() for b in exact))

        rec["serve"] = {"max_abs": max(float((a - b).abs().max()) for a, b in zip(sharded, one)),
                        "std": float(one[0].float().std()), "rms_from_f32": rms(sharded),
                        "one_device_rms_from_f32": rms(one),
                        "one_device_max_from_f32": max(float((a - b).abs().max())
                                                       for a, b in zip(one, exact)),
                        "finite": all(bool(torch.isfinite(x).all()) for x in sharded),
                        "one_device_prefill_ms": one_s * 1e3}
    del params, pp, model
    torch.cuda.empty_cache()
    return rec


def sharded_hybrid_report(ranks, label: str) -> dict:
    """Check and report the ranks' sharded hybrid (``_sharded_hybrid_case``):
    the f32 loss and gradients against the one-device step, the bf16 steps'
    collectives equal to the dry-run's of the same cut cell, no kernel
    launched in training; the sharded prefill's flash_attention launches
    (once a prefill on every rank) and each rank's first call within the
    bf16 rule of its plain version (``check_attention``, on the rank), its
    state in ``cache_specs``'
    placements, and its logits and decode steps' held to the one-device
    run's: the RMS distance of the sharded run's logits from the f32 run
    within NOISE_FACTOR × the one-device bf16 run's (or LOGIT_STD_SHARE of
    their std)."""
    from dataclasses import replace

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    recs = [rk["hybrid"] for rk in ranks]
    r0 = recs[0]
    full = get_config(ZAMBA_ARCH)
    cut = replace(full, n_layers=SHARDED_HYBRID_DEPTH)
    loss_gap = abs(r0["grads_loss"] - r0["one_device_loss"]) / abs(r0["one_device_loss"])
    bounds = [max(TRAIN_GRAD_REL, WITNESS_FACTOR * w) for w in r0["witness"]]
    worst = max(r0["grad_rel"])
    log(f"sharded hybrid check ({label}): {ZAMBA_ARCH} {SHARDED_HYBRID_DEPTH} of "
        f"{full.n_layers} layers f32 (cut: gloo copies every collective through the host, and "
        f"the mixer's gather of in_proj's output is B/2 × S × 14,576 a layer), B={TRAIN_B}, "
        f"S={TRAIN_S}, microbatch {SHARDED_MICRO}: loss {r0['grads_loss']:.9g} against the "
        f"one-device {r0['one_device_loss']:.9g} (rel {loss_gap:.3g}, rtol {TRAIN_LOSS_RTOL:g}; "
        f"f64 {r0['one_device_f64_loss']:.9g}); gradients' largest ‖Δ‖/‖g‖ over "
        f"{len(r0['grad_rel'])} leaves {worst:.3g} (within {TRAIN_GRAD_REL:g}: "
        f"{sum(g <= TRAIN_GRAD_REL for g in r0['grad_rel'])} leaves); the one-device f32 step's "
        f"own distance from its f64 step up to {max(r0['witness']):.3g}, so bounds up to "
        f"{max(bounds):.3g} a leaf")
    if not (loss_gap <= TRAIN_LOSS_RTOL
            and all(g <= bnd for g, bnd in zip(r0["grad_rel"], bounds))):
        raise AssertionError(f"the sharded hybrid step differs from the one-device step: loss "
                             f"{loss_gap:.3g}, gradients {r0['grad_rel']} against {bounds}")
    losses = r0["losses"]
    if any(rk["losses"] != losses for rk in recs):
        raise AssertionError(f"sharded hybrid: the ranks' losses differ: "
                             f"{[rk['losses'] for rk in recs]}")
    if not all(math.isfinite(x) for x in losses) or not all(rk["finite"] for rk in recs):
        raise AssertionError(f"sharded hybrid losses {losses} or parameters not finite")
    if any(rk["train_launches"] for rk in recs):
        raise AssertionError(f"the sharded hybrid train step launched {r0['train_launches']}")
    if any(rk["comm"] != r0["comm"] for rk in recs):
        raise AssertionError("sharded hybrid: the ranks issued other collectives")
    spec = {k: torch.empty((TRAIN_B, TRAIN_S), dtype=d, device="meta")
            for k, d in (("tokens", torch.int32), ("labels", torch.int32),
                         ("mask", torch.float32))}
    dry = dryrun.trace_cell(cut, "train_4k", SHARDED_MESH, ("data", "model"),
                            microbatch=SHARDED_MICRO, batch_override=spec)
    if dry["collective_by_kind"] != r0["comm"]:
        raise AssertionError(f"sharded hybrid: the dry-run's collectives "
                             f"{dry['collective_by_kind']} differ from the card's {r0['comm']}")
    # the prefill over the mesh: each rank launched flash_attention once a
    # point, at its own sequences and heads, within the bf16 rule
    points = cut.n_attn_points
    local = [TRAIN_B // SHARDED_MESH[0], full.n_heads // SHARDED_MESH[1], TRAIN_S, full.d_head]
    for r, rk in enumerate(recs):
        if rk["serve_launches"] != {"flash_attention": points}:
            raise AssertionError(f"sharded hybrid prefill: rank {r} launched "
                                 f"{rk['serve_launches']}, not flash_attention {points}")
        if rk["fa_check"]["shape"] != local:
            raise AssertionError(f"sharded hybrid prefill: rank {r}'s flash_attention ran at "
                                 f"{rk['fa_check']['shape']}, not its own {local}")
        if rk["state_placements"] != rk["cache_specs"]:
            raise AssertionError(f"sharded hybrid: rank {r}'s state placed "
                                 f"{rk['state_placements']}, not {rk['cache_specs']}")
    sv = r0["serve"]
    limit = max(LOGIT_STD_SHARE * sv["std"], NOISE_FACTOR * sv["one_device_rms_from_f32"])
    if not (sv["finite"] and sv["rms_from_f32"] <= limit):
        raise AssertionError(f"sharded hybrid prefill and decode: the logits' RMS distance from "
                             f"the f32 run {sv['rms_from_f32']} is over {limit} (the larger of "
                             f"{LOGIT_STD_SHARE} of their std {sv['std']} and {NOISE_FACTOR} × "
                             f"the one-device bf16 run's {sv['one_device_rms_from_f32']})")
    step_ms = [statistics.median(rk["step_s"]) * 1e3 for rk in recs]
    out = {"loss_rel": loss_gap, "grad_rel_max": worst, "witness_max": max(r0["witness"]),
           "grad_over_bound_max": max(g / bnd for g, bnd in zip(r0["grad_rel"], bounds)),
           "losses": losses, "step_ms_median_per_rank": step_ms,
           "step_ms_per_rank": [[t * 1e3 for t in rk["step_s"]] for rk in recs],
           "warmup_s": [rk["warmup_s"] for rk in recs], "check_s": [rk["check_s"] for rk in recs],
           "collectives_per_step": r0["comm"], "peak_gb_per_rank": [rk["peak_gb"] for rk in recs],
           "dryrun": {"collectives": dry["collective_by_kind"],
                      "peak_gb_per_device": dry["peak_bytes"] / 1e9, "trace_s": dry["trace_s"]},
           "prefill_ms_per_rank": [rk["prefill_ms"] for rk in recs],
           "one_device_prefill_ms": sv["one_device_prefill_ms"],
           "serve": dict(sv, limit=limit), "state_placements": r0["state_placements"],
           "flash_attention_launches": sum(rk["serve_launches"]["flash_attention"]
                                           for rk in recs),
           "flash_attention_per_rank": [rk["fa_check"] for rk in recs]}
    log(f"sharded hybrid train ({label}): {ZAMBA_ARCH} {SHARDED_HYBRID_DEPTH} layers bf16, "
        f"B={TRAIN_B}×S={TRAIN_S}: losses {[round(x, 4) for x in losses]}; step "
        f"{[round(x, 1) for x in step_ms]} ms median of {SHARDED_HYBRID_STEPS} per rank "
        f"(synchronised); collectives a step {json.dumps(r0['comm'])} (the dry-run's on a fake "
        f"world of 4: the same); peak allocated {[round(rk['peak_gb'], 3) for rk in recs]} GB "
        f"per rank (dry-run {dry['peak_bytes'] / 1e9:.3f} GB per device); no kernel launched")
    log(f"sharded hybrid prefill ({label}): {TRAIN_B}×{TRAIN_S} bf16 through flash_attention "
        f"(fa_wgmma<112>, {r0['local_heads']} of {full.n_heads} heads a rank), "
        f"{[round(rk['prefill_ms'], 1) for rk in recs]} ms per rank (one device "
        f"{sv['one_device_prefill_ms']:.1f} ms); flash_attention launched {points} time(s) on "
        f"each rank, its first call at {local} against the plain version: max |Δ| "
        f"{[rk['fa_check']['max_abs_err'] for rk in recs]}, share of the bf16 bound "
        f"{[round(rk['fa_check']['bound_share'], 4) for rk in recs]}; the state in "
        f"cache_specs' placements {r0['state_placements']}; the "
        f"prefill's and {SHARDED_DECODE_STEPS} decode steps' logits: RMS distance from the f32 "
        f"run {sv['rms_from_f32']:.6g} (limit {limit:.6g}: the one-device bf16 run's "
        f"{sv['one_device_rms_from_f32']:.6g}, std {sv['std']:.6g}); max |Δ| from the "
        f"one-device bf16 run {sv['max_abs']:.6g}, the one-device run's max |Δ| from f32 "
        f"{sv['one_device_max_from_f32']:.6g}")
    return out


def phase_sharded_train(smi: str):
    """Qwen2-1.5B's train step sharded over a (data 2, model 2) mesh of
    SHARDED_RANKS gloo ranks sharing the card (``lower_to_pjit``: the
    sharding table's placements, ZeRO-1 moments, the ZeRO-2 accumulator,
    the vocab-split CE), at SHARDED_DEPTH layers: f32 against the one-device
    step, then timed in f32 and bf16; beside it the dry-run of the same cut
    cell on a fake world of 4 (its collectives must be the ones counted
    here); then the MoE and the hybrid over the same mesh.  Returns (the
    report, [rank 0's first flash_attention call of the sharded hybrid
    prefill, its inputs on the card] for phase_kernels)."""
    import pickle
    import tempfile
    from dataclasses import replace

    import torch
    import torch.multiprocessing as mp

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    t_phase = time.perf_counter()
    # the ranks are other processes: what this one's allocator keeps cached
    # from earlier phases (tens of GB after training) goes back to the card
    gc.collect()
    torch.cuda.empty_cache()
    base = get_config(SERVE_ARCH)
    label = f"{SHARDED_RANKS} ranks on one {smi}, gloo"
    log(f"sharded train: {base.arch}'s full widths at {SHARDED_DEPTH} of its {base.n_layers} "
        f"layers (cut: gloo copies every collective through the host at about 1 GB/s, and an "
        f"f32 step moves about 2.2 GB a rank at this depth); mesh data {SHARDED_MESH[0]} × "
        f"model {SHARDED_MESH[1]}, B={TRAIN_B}, S={TRAIN_S}, microbatch {SHARDED_MICRO}")
    with tempfile.TemporaryDirectory() as tmp:
        spawn = mp.get_context("spawn")
        procs = [spawn.Process(target=_sharded_rank, args=(r, SHARDED_RANKS, tmp))
                 for r in range(SHARDED_RANKS)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + SHARDED_JOIN_S
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        codes = [p.exitcode for p in procs]
        if hung or any(codes):
            raise AssertionError(f"sharded train ranks exited {codes} ({len(hung)} killed)")
        ranks = [pickle.loads((Path(tmp) / f"rank{r}.pkl").read_bytes())
                 for r in range(SHARDED_RANKS)]
    r0 = ranks[0]
    refused = sorted(op for op, ok in r0["probe"].items() if ok != "ok")
    if refused:
        raise AssertionError(f"gloo refuses {refused} on CUDA tensors: {r0['probe']}")
    report: dict = {"card": smi, "label": label, "probe": r0["probe"]}
    for r, rk in enumerate(ranks):
        if rk["device"] != "cuda:0":
            raise AssertionError(f"sharded rank {r} computed on {rk['device']}")
    # 1. f32: the sharded step against the one-device step
    f32 = r0["float32"]
    loss_gap = abs(f32["grads_loss"] - f32["one_device_loss"]) / abs(f32["one_device_loss"])
    worst = max(f32["grad_rel"])
    over = [(i, d, bnd) for i, (d, bnd) in enumerate(f32["update"]) if d > bnd]
    log(f"sharded train check ({label}): f32 loss {f32['grads_loss']:.9g} against the "
        f"one-device {f32['one_device_loss']:.9g} (rel {loss_gap:.3g}, rtol {TRAIN_LOSS_RTOL:g}); "
        f"gradients' largest ‖Δ‖/‖g‖ over {len(f32['grad_rel'])} leaves {worst:.3g} (bound "
        f"{TRAIN_GRAD_REL:g}); step 1's parameters: largest ‖Δ‖ over its bound "
        f"{max(d / bnd for d, bnd in f32['update']):.3g} (‖Δ‖ ≤ {SHARDED_UPD_RTOL:g}·‖u‖ + "
        f"{SHARDED_UPD_ATOL:g}·lr·√n)")
    if not (loss_gap <= TRAIN_LOSS_RTOL and all(g <= TRAIN_GRAD_REL for g in f32["grad_rel"])) \
            or over:
        raise AssertionError(f"the sharded f32 step differs from the one-device step: loss "
                             f"{loss_gap:.3g}, gradients {f32['grad_rel']}, updates over {over}")
    report["check"] = {"loss_rel": loss_gap, "grad_rel_max": worst,
                       "update_over_bound_max": max(d / bnd for d, bnd in f32["update"]),
                       "one_device_f32_step_ms": f32["one_device_step_s"] * 1e3}
    log(f"sharded train: the one-device f32 step on rank 0, alone on the card: "
        f"{f32['one_device_step_s'] * 1e3:.1f} ms (its second call)")
    # 2. the timed runs, the collectives and memory, beside the dry-run
    for dtype in ("float32", "bfloat16"):
        recs = [rk[dtype] for rk in ranks]
        losses = recs[0]["losses"]
        if any(rk["losses"] != losses for rk in recs):
            raise AssertionError(f"sharded {dtype}: the ranks' losses differ: "
                                 f"{[rk['losses'] for rk in recs]}")
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"sharded {dtype} losses {losses}: not finite or not falling")
        if not all(rk["finite"] for rk in recs):
            raise AssertionError(f"sharded {dtype}: a parameter is not finite")
        if any(rk["launches"] for rk in recs):
            raise AssertionError(f"the sharded train step launched {recs[0]['launches']}")
        if any(rk["comm"] != recs[0]["comm"] for rk in recs):
            raise AssertionError(f"sharded {dtype}: the ranks issued other collectives")
        logits = [x for x in recs[0]["records"] if x[0] == "all_gather_into_tensor"
                  and len(x[1]) == 3 and x[1][-1] in (base.vocab, base.vocab // SHARDED_MESH[1])]
        if logits:
            raise AssertionError(f"sharded {dtype}: logits were all-gathered: {logits[:4]}")
        cut = replace(base, n_layers=SHARDED_DEPTH, dtype=dtype)
        spec = {k: torch.empty((TRAIN_B, TRAIN_S), dtype=d, device="meta")
                for k, d in (("tokens", torch.int32), ("labels", torch.int32),
                             ("mask", torch.float32))}
        dry = dryrun.trace_cell(cut, "train_4k", SHARDED_MESH, ("data", "model"),
                                microbatch=SHARDED_MICRO, batch_override=spec)
        if dry["collective_by_kind"] != recs[0]["comm"]:
            raise AssertionError(f"sharded {dtype}: the dry-run's collectives "
                                 f"{dry['collective_by_kind']} differ from the card's "
                                 f"{recs[0]['comm']}")
        step_ms = [statistics.median(rk["step_s"]) * 1e3 for rk in recs]
        report[dtype] = {
            "losses": losses, "step_ms_median_per_rank": step_ms,
            "step_ms_per_rank": [[t * 1e3 for t in rk["step_s"]] for rk in recs],
            "warmup_s": [rk["warmup_s"] for rk in recs], "setup_s": [rk["setup_s"] for rk in recs],
            "collectives_per_step": recs[0]["comm"],
            "peak_gb_per_rank": [rk["peak_gb"] for rk in recs],
            "placed_state_gb_per_rank": [rk["local_gb"] for rk in recs],
            "dryrun": {"collectives": dry["collective_by_kind"],
                       "peak_gb_per_device": dry["peak_bytes"] / 1e9,
                       "flops_per_device": dry["flops"], "bytes_per_device": dry["bytes"],
                       "trace_s": dry["trace_s"]}}
        log(f"sharded train ({label}): {base.arch} {SHARDED_DEPTH} layers {dtype}, "
            f"B={TRAIN_B}×S={TRAIN_S}: losses {[round(x, 4) for x in losses]}; step "
            f"{[round(x, 1) for x in step_ms]} ms median of {SHARDED_STEPS} per rank "
            f"(synchronised; warm-up {max(rk['warmup_s'] for rk in recs):.2f} s); collectives "
            f"a step {json.dumps(recs[0]['comm'])} (the dry-run's on a fake world of 4: the "
            f"same); peak allocated {[round(rk['peak_gb'], 3) for rk in recs]} GB per rank "
            f"(dry-run {dry['peak_bytes'] / 1e9:.3f} GB per device); no all-gather of logits; "
            f"no kernel launched")
    report["moe"] = sharded_moe_report(ranks, label)
    report["hybrid"] = sharded_hybrid_report(ranks, label)
    report["phase_s"] = time.perf_counter() - t_phase
    log("sharded train: " + json.dumps(report))
    log(f"sharded train phase took {report['phase_s']:.1f} s")
    name, args, kw = ranks[0]["hybrid"]["fa_call"]
    return report, [(name, tuple(a.cuda() for a in args), kw)]


def sharded_moe_report(ranks, label: str) -> dict:
    """Check and report the ranks' sharded MoE step (``_sharded_moe_case``):
    the f32 loss and gradients against the one-device step, the dropped
    choices equal to its, the collectives a step equal to the dry-run's of
    the same cut cell, no kernel launched; step ms and peak GB per rank."""
    from dataclasses import replace

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    recs = [rk["moe"] for rk in ranks]
    r0 = recs[0]
    full = get_config(MOE_ARCH)
    cut = replace(full, n_layers=SHARDED_MOE_DEPTH, dtype="float32")
    loss_gap = abs(r0["grads_loss"] - r0["one_device_loss"]) / abs(r0["one_device_loss"])
    worst = max(r0["grad_rel"])
    log(f"sharded MoE check ({label}): {MOE_ARCH} {SHARDED_MOE_DEPTH} of {full.n_layers} "
        f"layers f32 (cut: four ranks share the card's 80 GB, rank 0 beside the one-device "
        f"step), B={TRAIN_B}, S={TRAIN_S}, microbatch {SHARDED_MICRO}: loss "
        f"{r0['grads_loss']:.9g} against the one-device {r0['one_device_loss']:.9g} (rel "
        f"{loss_gap:.3g}, rtol {TRAIN_LOSS_RTOL:g}); gradients' largest ‖Δ‖/‖g‖ over "
        f"{len(r0['grad_rel'])} leaves {worst:.3g} (bound {TRAIN_GRAD_REL:g}); dropped choices "
        f"per rank {[rk['drops'][0] for rk in recs]} of {r0['drops'][1]}, one device "
        f"{r0['one_device_drops'][0]} of {r0['one_device_drops'][1]}")
    if not (loss_gap <= TRAIN_LOSS_RTOL and all(g <= TRAIN_GRAD_REL for g in r0["grad_rel"])):
        raise AssertionError(f"the sharded MoE step differs from the one-device step: loss "
                             f"{loss_gap:.3g}, gradients {r0['grad_rel']}")
    if any(rk["drops"] != r0["one_device_drops"] for rk in recs) or not r0["drops"][0]:
        raise AssertionError(f"sharded MoE drops {[rk['drops'] for rk in recs]} against the "
                             f"one-device {r0['one_device_drops']}")
    losses = r0["losses"]
    if any(rk["losses"] != losses for rk in recs):
        raise AssertionError(f"sharded MoE: the ranks' losses differ: "
                             f"{[rk['losses'] for rk in recs]}")
    if not all(math.isfinite(x) for x in losses) or not all(rk["finite"] for rk in recs):
        raise AssertionError(f"sharded MoE losses {losses} or parameters not finite")
    if any(rk["launches"] for rk in recs):
        raise AssertionError(f"the sharded MoE step launched {r0['launches']}")
    if any(rk["comm"] != r0["comm"] for rk in recs):
        raise AssertionError("sharded MoE: the ranks issued other collectives")
    spec = {k: torch.empty((TRAIN_B, TRAIN_S), dtype=d, device="meta")
            for k, d in (("tokens", torch.int32), ("labels", torch.int32),
                         ("mask", torch.float32))}
    dry = dryrun.trace_cell(cut, "train_4k", SHARDED_MESH, ("data", "model"),
                            microbatch=SHARDED_MICRO, batch_override=spec)
    if dry["collective_by_kind"] != r0["comm"]:
        raise AssertionError(f"sharded MoE: the dry-run's collectives {dry['collective_by_kind']} "
                             f"differ from the card's {r0['comm']}")
    step_ms = [statistics.median(rk["step_s"]) * 1e3 for rk in recs]
    out = {"loss_rel": loss_gap, "grad_rel_max": worst, "drops": r0["drops"],
           "losses": losses, "step_ms_median_per_rank": step_ms,
           "step_ms_per_rank": [[t * 1e3 for t in rk["step_s"]] for rk in recs],
           "warmup_s": [rk["warmup_s"] for rk in recs], "setup_s": [rk["setup_s"] for rk in recs],
           "collectives_per_step": r0["comm"], "peak_gb_per_rank": [rk["peak_gb"] for rk in recs],
           "dryrun": {"collectives": dry["collective_by_kind"],
                      "peak_gb_per_device": dry["peak_bytes"] / 1e9, "trace_s": dry["trace_s"]}}
    log(f"sharded MoE train ({label}): {MOE_ARCH} {SHARDED_MOE_DEPTH} layer(s) f32, "
        f"B={TRAIN_B}×S={TRAIN_S}: losses {[round(x, 4) for x in losses]}; step "
        f"{[round(x, 1) for x in step_ms]} ms median of {SHARDED_MOE_STEPS} per rank "
        f"(synchronised); collectives a step {json.dumps(r0['comm'])} (the dry-run's on a fake "
        f"world of 4: the same); peak allocated {[round(rk['peak_gb'], 3) for rk in recs]} GB "
        f"per rank (dry-run {dry['peak_bytes'] / 1e9:.3f} GB per device); the dropped share "
        f"{r0['drops'][0] / r0['drops'][1]:.4f}; no kernel launched")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=5.0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--profile", action="store_true")
    a = ap.parse_args()
    global T_START
    T_START = time.perf_counter()

    # The families' training runs within a few GB of the card's memory; with
    # fixed-size segments the caching allocator once left 18 GB reserved
    # but unusable for a 4.67 GiB block of Zamba2-7B's AdamW update.
    # Expandable segments grow in place instead.  Set before torch's first
    # allocation; the ranks spawned later inherit it.
    import os

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import warnings
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.obs import DegradedWarning

    # a plan that steps down the fallback ladder fails the run, except in
    # phase_fallback, which lifts this inside its own catch_warnings()
    warnings.simplefilter("error", DegradedWarning)

    # full-f32 products in the plain versions: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_card()
    phase_build()
    stamp("build")
    with ThreadPoolExecutor(8) as pool:
        phase_edges()
        phase_edges_la(pool)
        phase_edges_attention()
        stamp("edge cases")
        tables, ctx, frames, launches, captured = phase_main_path(a.sf)
        km_launches, km_captured, seg_inputs, km_times, km_step = phase_kmeans(pool)
        seg_launches, seg_captured = phase_segsum(seg_inputs)
        stamp("TPC-H, k-means and segsum paths")
        t0 = time.perf_counter()
        determinism = phase_determinism()
        log(f"determinism phase took {time.perf_counter() - t0:.1f} s: " + json.dumps(determinism))
        phase_parallel(tables, frames)
        phase_default_tiers(tables, ctx, frames, min(a.reps, 3))
        phase_plan_cache(frames, a.reps)
        phase_dict(a.reps)
        phase_sql(tables, ctx)
        stamp("parallel, tiers, plan cache, dict and SQL")
        driver_s = {}
        for name, run in (("cost", lambda: phase_cost(tables, ctx, frames, min(a.reps, 3))),
                          ("admission", lambda: phase_admission(tables, ctx, frames)),
                          ("traced", lambda: phase_traced(tables, ctx, frames, min(a.reps, 3))),
                          ("control_flow", phase_control_flow)):
            t0 = time.perf_counter()
            run()
            driver_s[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_fallback(tables, ctx, frames)
        driver_s["fallback"] = time.perf_counter() - t0
        log(f"driver phases took {sum(driver_s.values()):.1f} s: " + json.dumps(driver_s))
        t0 = time.perf_counter()
        stream_launches = phase_stream(tables, ctx, frames, a.reps)
        log(f"stream phase took {time.perf_counter() - t0:.1f} s")
        spmd_launches = phase_spmd(tables, frames, a.reps, pool, smi)
        stamp("driver, stream and spmd phases")
        fa_launches, fa_captured, serve_report, serve_wave = serve_cell(SERVE_ARCH, smi)
        train_report = phase_train(smi, a.profile)
        if not a.profile:
            serve_wave = None  # frees Qwen2-1.5B's served parameters before the MoE phases
        stamp("Qwen2-1.5B served and trained")
        sharded, calls = phase_sharded_train(smi)
        fa_launches += sharded["hybrid"]["flash_attention_launches"]
        fa_captured += calls
        del sharded, calls
        stamp("sharded training")
        phases = {
            MOE_ARCH: lambda: serve_cell(MOE_ARCH, smi, layers_cut=MOE_SERVE_LAYERS,
                                         check_block=True, sample_calls=True),
            MIXTRAL_ARCH: lambda: serve_cell(MIXTRAL_ARCH, smi, layers_cut=MIXTRAL_LAYERS,
                                             requests_n=SERVE_BATCH, gen=MIXTRAL_GEN,
                                             chunked=False, sample_calls=True),
            VLM_ARCH: lambda: phase_vlm(smi),
            ZAMBA_ARCH: lambda: phase_zamba2(smi),
            RWKV_ARCH: lambda: phase_rwkv(smi),
            WHISPER_ARCH: lambda: phase_whisper(smi),
            **{a: lambda a=a, kw=kw: serve_cell(a, smi, gen=DENSE_GEN, sample_calls=True, **kw)
               for a, kw in DENSE_SERVE.items()},
        }
        for arch, run in phases.items():
            n, calls = run()[:2]  # the rest holds the model: dropped before the next phase
            fa_launches += n
            fa_captured += calls
            stamp(f"{arch}'s phase")
        families_report = phase_train_families(smi)
        stamp("training the families")
        launches.update(kmeans_step=km_launches["kmeans_step"], segsum=seg_launches["segsum"],
                        flash_attention=fa_launches)
        for k, n in list(stream_launches.items()) + list(spmd_launches.items()):
            launches[k] += n
        captured += km_captured + seg_captured + fa_captured
        kernels = phase_kernels(captured, launches, pool)
        stamp("kernels against their plain versions")
    phase_queries(tables, frames, a.reps)
    report_kmeans(km_times)
    report_serve(serve_report)
    log("training: " + json.dumps(train_report))
    log("training the MoE, VLM, hybrid and RWKV families: " + json.dumps(
        {k: v["cell"] for k, v in families_report.items() if isinstance(v, dict)}))
    if a.profile:
        phase_profile({
            "one pass over the six queries": lambda: [f.collect(device="cuda")
                                                      for f in frames.values()],
            f"one pass over the six queries with parallel={PARALLEL}":
                lambda: [f.collect(device="cuda", parallel=PARALLEL) for f in frames.values()],
            "one k-means step": km_step,
            f"one serving wave ({SERVE_BATCH}×{SERVE_PROMPT} prefill, {SERVE_GEN} steps)":
                serve_wave,
        }, captured)
    del captured, km_captured, seg_captured, seg_inputs, fa_captured
    report_generated("at the end")
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
