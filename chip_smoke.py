"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Run from the repository root; it puts ``src`` on ``sys.path`` itself,
imports nothing of ``jax`` or the reference package ``repro``, and builds
the CUDA kernels from ``src/repro_torch/csrc`` at first use (one ``nvcc``
per source, in parallel).  Phases, each ended by a device synchronize:

1. environment — card name and power limit, torch/CUDA versions, build;
2. each kernel against its plain PyTorch version on the card, at ragged
   shapes and at the main path's shapes (max abs diff ≤ 1e-6 required;
   0.0 for the similarity kernel): the similarity kernel's two routes by
   name (``fused_similarity.routes``: "simt" for f32 rows, "imma" for the
   same values as int8), every measure (pcc_sig and "all" included), m
   and n off the 128 / 64 / 16 tiles, D off 16, signed values at
   max_value 15 (one u8 square plane) and 16 (the hi plane too), and the
   exact domain's edge (max_value² · D = 2^24 taken, one item more and
   int8 at D = 3952 without max_value raising); the tile-predict kernel's
   two routes by name (``fused_tile_predict.routes``: "int8" for the int8
   gather source, "f32" for f32 ratings) at k = 1 / 7 / 40 / 65 / 100,
   over the whole item range, 512-item tiles and ranges off 16 (lo = 3,
   100), and with ids outside [0, U), bit for bit; the "f32" route on
   half stars at MovieLens-25M's recommend block (1,024 queries, k = 40,
   59,047 items), bit for bit;
3. the main path at the paper's size (ML-1M surrogate, 6040 × 3952,
   pcc, k = 40): ``CFEngine(backend="kernel")`` fit → predict / MAE →
   ``recommend`` → ``update_ratings`` (oracle-checked) → a
   ``BatchingServer`` answering 512 requests; the kernels' launch counts
   are zeroed just before and read just after, and must be > 0, every
   similarity launch on the "imma" route and every tile-predict launch
   (one a user block, over every item) on the "int8" route; a steady
   fit's wall and device time under ``torch.profiler``.  Then the
   sequential backend (plain torch) must give the same neighbor and item
   ids and the same ``predict()`` bit for bit, and a small input must
   agree between the CPU path and the card;
4. the approximate index's kernels (centroid distances, scan / select
   top-M, co-rated rerank) against their plain versions on the card, at
   ragged shapes (ids equal, values within 1e-6, 0 expected; the
   distances bit for bit at 1, 33, 78, 97 and 182 centroids, and a row
   subset bit for bit the full call); the
   radix select also on ±0.0, all −inf rows, m = 1, m = L, m above the
   finite count and a row too long for shared memory, and the bulk
   recommend's 1,024-user blocks at 17,770 (staged) and 59,047 (unstaged)
   scores with 5.0 ties across the top-10 cut, its values equal
   bit for bit (signs of zeros included); the scan bit for bit at the
   approx path's and phase 6's block shapes, P not a multiple of 4, ties,
   and raising past the select's m ≤ 16384; the rerank bit for bit on
   both routes (``fused_rerank_scores.routes``: "simt" for f32 queries,
   "imma" for int8 × int8, values up to 127 included), every measure,
   raising outside the int8 route's exact domain;
5. the approx path at 6040 × 3952, pcc, k = 40, default ``IndexConfig``:
   ``CFEngine(neighbor_mode="approx", backend="kernel")`` fit →
   ``recall_vs_exact`` → a cluster-restricted query (n_probe 4, 1024
   users) → ``update_ratings`` (oracle-checked) → a ``BatchingServer``
   answering 256 requests, with the launch counts zeroed before and read
   after (kernels 3-6 must be > 0, every rerank launch on the "imma"
   route); then the same engine with
   ``IndexConfig(use_kernel=False)`` (the plain versions, on the card) must
   give equal spill ids and distances, centroids, shortlists, neighbor ids
   and scores, and two fits must give identical centroids; and the
   index's staged pipeline (``query_mode_override="staged"``: the scan
   kernel, shortlists through the host, the grouped rerank kernel) must
   equal its fused chain over all 6040 users bit for bit, ids and scores,
   with kernels 4 and 6 launched (every rerank launch "imma");
6. the scale phase at U = 32768 (``BENCH_index.json``'s
   ``index_cosine_U32768`` row: cosine, k = 20, raw features,
   project_dim 512, rerank_frac 0.02, seed 0): index fit and full query
   against the exact kernel-backend top-k; recall@20 ≥ 0.94 and equal to
   the earlier designs' 0.9489044189453125; every rerank launch of the
   query on the "imma" route; then the staged pipeline, as every
   ``BENCH_index.json`` row was measured: recall@20 exactly
   0.9489044189453125, ids and scores equal to the fused query's;
7. the support kernel (the item index's segmented SpMM) against its
   plain versions on the card, at ragged shapes (b = 1, widths not a
   multiple of 512 or of 4, all-masked rows, k = 1) and at the full
   6040-user chunk (max abs diff 0.0 required): the "table" route on
   random tables, and both routes by name (``fused_support_scores.routes``:
   "int8" from int8 ratings and means, "table" from the tables of the same
   data) against the int8 route's plain version; and the identity that
   makes the approx recommend exact: on integer ratings the support score
   equals the tile-predict kernel's exact prediction bit for bit;
8. the approx-recommend path at 6040 × 3952, pcc, k = 40, exact
   kernel-backend neighbors, default ``ItemIndexConfig``:
   ``CFEngine(recommend_mode="approx")`` fit → ``recommend(all, n=10)``
   (bitwise equal to the exact recommend at shortlist 512 and 64) →
   ``recommend_recall_vs_exact`` (1.0) → ``update_ratings``
   (oracle-checked, item index included) → a ``BatchingServer`` with the
   default ``DegradationLadder()`` answering 256
   requests (none returns a rated item), with the launch counts zeroed
   before and read after (kernels 3, 5 and 7 must be > 0, every support
   launch on the "int8" route, and the update patching the gather source
   and building no table); then the item
   index on the plain versions (``use_kernel=False``) must fit and
   recommend bitwise the same;
9. ``BENCH_recommend.json``'s ``recommend_cosine_U32768`` row on phase
   6's matrix (cosine, k = 40, approx neighbors at rerank_frac 0.03 and
   project_dim 384, shortlist 64, seed 0): recall@10 of approx against
   exact recommend must be 1.0, the reference's figure;
10. the flash-attention kernel against its plain version on the card:
    Sq ≠ Skv, ragged tails, groups 1/4/8, d = 64 / 128 and d = 192 with
    dv = 128, causal and not, decode (Sq = 1) and a 5-query chunk with a
    ragged per-row kv_len (keys past it hold NaN and must not be read),
    fully masked rows (Sq > Skv, causal: exactly 0), f32 (atol 1e-5) and
    bf16 (against the plain f32 result rounded to bf16: atol 2e-2 and,
    elementwise, one bf16 unit in the last place plus 1e-5); then the
    bf16 routes by name: Sq·group of 16 (split-K decode) and 17
    (tensor-core prefill), per-row kv_len of 0, 1, less than a split, one
    split and every split on both routes (exact zeros at kv_len 0), d /
    dv of 40, 72 and 256 with dv ≠ d, and rows 65 elements apart (the
    scalar staging path); each call's route counter is checked;
11. LM serving: Llama-3.2-1B at full width (16 layers, d 2048, 32/8
    heads, vocab 128256, bf16), weights from a seeded generator on the
    card; ``build_step`` prefill on 4 prompts × 2048 tokens (``lm_batch``
    seed 0, max_len 2080) and 16 greedy decode steps with the flash
    kernel's launch and route counts zeroed before and read after (> 0 in
    prefill and in decode; every prefill launch on the tensor-core route,
    every decode launch on the split-K route), ``cache["len"]`` 2064,
    the layer-0 q / k / v of the
    prefill through kernel and plain version, as they are (bf16) and as
    f32 copies (atol 1e-5); then the same model with
    the attention on the plain version, teacher-forced on the same
    tokens: logits compared at every step, argmax equal on every row
    whose plain top-2 margin exceeds 0.05;
12. each kernel's time against its plain version, a library yardstick
    and its bound, at the main paths' shapes (CUDA events); the
    similarity kernel's "imma" launch also beside six ``torch._int_mm``
    calls, its f32 "simt" route and the f32 peak's bound; the support
    kernel's "int8" route also beside its "table" route, the tables'
    bytes bound and the pinned order's no-FMA floor; the flash
    kernel at its prefill and its decode launch (that launch's inputs
    also as f32 copies against the plain version, atol 1e-5), the select
    at both of its path shapes (the cluster query's Q 256 × L 8192,
    m 906, and the item index's Q 6040 × L 3952, m 512, each beside
    ``torch.topk``), the scan's two launches (scores, radix select)
    alone, the rerank beside six ``torch._int_mm`` calls and on its
    f32 route, the tile predictor at the recommend's launch (a 1024-user
    block over every item, and one 512-item tile) beside
    ``torch.sparse.mm`` and the no-FMA floor, the centroid distances
    beside ``torch.cdist().square()``, and the previous designs' times
    of kernels 2, 3, 4, 5, 6 and 8 beside the new ones (kernels 2 and 3,
    the decode launch, the selects and their library calls are timed
    queued behind a spin kernel, so the host's work to enqueue them is
    not counted; each call with it is logged too); the bounds of the
    support kernel and the tile predictor count the operations that this
    run's data needs, 4 for each rated element of a weighted neighbor
    row (an unrated one adds ±0, which the kernels skip);
13. ``torch.profiler``: where the device time of a steady exact fit, of
    recommend(all users), of an approx query (16 rows) and the same query
    in the staged mode, of an approx recommend(all users), of the LM
    prefill and of one LM decode step goes, and the device's busy share;

then the CF engines and the LM are dropped, and the recsys CTR slice
runs:

14. the embedding-bag kernel against its plain version on the card:
    B = L = 1 at D = 1 / 10 / 128, all-padding bags (mean exactly 0), −1
    spread through the bags, f32 and bf16 tables, sum and mean, int32 and
    int64 ids, both routes ("warp", "slots") taken, one
    launch on a bf16 table of 2.18e9 elements (max abs diff 0.0
    required); the check launch's and the bag launch's counts of ids
    past the table == the plain count, and the wrapper raises on them;
15. DLRM-MLPerf at its published widths (26 fields, embed 128, bottom
    13-512-256-128, top 1024-1024-512-256-1), every field capped at 20 M
    rows (104,064,204 rows, 13.32 B parameters, 49.6 GiB f32 on the card;
    the cut is logged as ``reduced``), weights from a seeded generator on
    the card and scaled in place: ``build_step`` serve_p99 (512 rows, 60
    timed steps: p50 / p99 ms), serve_bulk (262,144 rows: rows/s) and
    retrieval_cand cut to 262,144 candidates; retrieval == forward on the
    substituted batch (1e-5); serve_p99's sharded-field ids as L = 1 bags
    through ``ops.embedding_bag`` == the step's lookups bit for bit; 2048
    multi-hot bags × L = 100 over the fused table (zipf ids, ~10 %
    padding), sum and mean, through ``ops.embedding_bag``, == plain; the
    launch counts zeroed before the steps, kernel 9's read after the bags
    (> 0, every one on the "warp" route);
16. kernel 9's time at (a) that multi-hot launch, (b) those L = 1 bags
    beside the serve step's own gather, and the multi-hot bags over FM's
    (c) D = 10 factor and (d) D = 1 linear tables: the launch alone, the
    plain version and ``F.embedding_bag`` as the library yardstick, with
    the L2 cache flushed before each call, and warm on the device alone;
    the wrapper with its id check back to back and one call's host wall;
    the bound) and ``torch.profiler`` over one DLRM serve_p99 and one
    serve_bulk step; then the DLRM is dropped;
17. FM and xDeepFM at their full configs (Criteo-39 vocabularies, embed
    10, CIN 200-200-200, DNN 400-400): serve_p99, serve_bulk (xDeepFM cut
    to 16,384 rows, logged) and retrieval_cand (1,048,576 candidates;
    xDeepFM in 128 chunks of 8192); FM's factorised retrieval == its
    forward on the substituted batch (1e-5); the multi-hot bags over FM's
    factor and linear tables through ``ops.embedding_bag`` == plain, the
    launch counts zeroed before the path and read after it (four
    launches, all on the "slots" route);
18. the three models' smoke configs on a small input, the CPU path
    against the card (1e-5);
19. chaos: the four drills of ``benchmarks/bench_chaos.py``, written
    again on the port at that bench's full sizes (the engine: cosine,
    k 40, both approx indexes, 32 clusters, n_probe 8, shortlist 256, at
    2048 × 512): transient faults at batches 2, 4 and 6 of 24 waves of 8
    under ``RecoveryPolicy(max_restarts=3)`` (0 stranded futures,
    recoveries ≥ 3); a burst of 48 into a queue of 16 (shed + admitted =
    48, 0 stranded); faults inside ``update_ratings`` and mid-refold,
    recovered from the port's ``checkpoint`` (bit parity with a
    fault-free run, the torn index inconsistent before the restore and
    consistent after); and the DEGRADED rung's recall@20 at U = 8192,
    d = 1024 with the staged user-index mode (≥ 0.90);
20. sharded execution on a one-rank NCCL mesh (``torch.distributed``'s
    default group, created by the port over a file store, no network) at
    the paper's size: ``CFEngine(backend="sharded")`` and ``"ring"`` fit
    bitwise equal to ``backend="kernel"`` (every similarity launch on
    "imma", recommend through the tile-predict kernel, recommend ids
    equal), ``sharded_predict`` (the tile-predict kernel) and
    ``ring_sharded_predict`` within 1e-5 of ``predict()``, a
    ``ClusteredIndex`` fitted through the mesh bit-identical to the
    unsharded fit (kernel 3 launched), the item index's host support
    scorer's ``recommend(all, n=10)`` bitwise equal to the kernel
    scorer's and the exact recommend, FM's factor table through
    ``sharded_lookup(mesh=)`` == ``mesh=None``, and the sharded engine's
    state restored onto the CUDA mesh as DTensors whose ``full_tensor()``
    equals the numpy restore; each path's walls, and its launch counts
    (zeroed before, read after; added to the kernel line's counts);
21. the paper's pipeline through the legacy path, each step's launch
    counts zeroed before it and read after it (added to the kernel
    line's): ``UserCF(CFConfig(pcc, k 40))`` on the sequential engine at
    6040 × 3952 (the fit on kernel 1, every launch "imma", bit for bit
    ``CFEngine(backend="kernel")``; ``predict`` one kernel-2 launch on
    "int8", bit for bit the plain blocked predict; ``evaluate``); the
    paper's Figs. 3-6 (``BENCH_topk.json``: 1024 × 768, seed 0, jaccard /
    cosine / pcc × top-N 5 / 10 / 20 / 40 / 80) with precision, recall,
    F1 and MAE within 1e-6 of the file; the legacy ``BatchingServer(cf,
    ratings)`` answering 512 requests through kernel 2, ids equal to the
    facade server's; ``UserCF`` on the sharded and ring engines over the
    one-rank NCCL mesh, bit for bit the sequential engine; Slope One's
    deviations on the card bit for bit the CPU's and
    ``sharded_deviation``'s, its prediction within 2e-6 of the CPU's
    (384 × 300), its MAE; ``cf_movielens``'s ``fit_ml1m`` step (the ring
    engine, the surrogate padded with 104 zero users to 6144) bit for bit
    ``UserCF``'s sequential fit and its ``cf_predict`` step within 1e-5
    of ``UserCF.predict``; the plans of ``fit_1m_users`` and
    ``predict_bulk`` (256 GiB of f32 ratings) built, not run;

then the training slice:

22. kernel 8's backward (``csrc/flash_attention_bwd.cu``) against its
    plain version at Llama-3.2-1B's prefill shapes (B 4, Hq 32, Hkv 8,
    S 2048, d 64), bf16 on its "mma" route and f32 on "simt" (dQ, dK, dV
    each within 1e-2 / 2e-5 of its largest |gradient|; a second call
    bitwise equal); the forward's log-sum-exp on its three routes
    against the plain version's (1e-5 / 1e-4 absolute); the backward's
    time beside the plain version, autograd of
    ``scaled_dot_product_attention(enable_gqa=True)``'s backward and both
    bounds (five of the forward's two matmuls, half masked, at the bf16
    peak; the seven the deterministic design runs); the forward's
    prefill and decode times with lse off and on;
23. Llama-3.2-1B trained at full width (f32 master weights, bf16
    compute, AdamW, remat), train_4k's seq 4096 with the batch cut to 4
    in 2 µbatches: one step's loss and per-leaf gradients through kernel
    8's forward and backward against the plain attention on the same
    weights and batch — in f32 compute (the kernels' f32 routes) loss
    within 1e-3 relative and each leaf's ‖Δg‖/‖g‖ ≤ 1e-2; in the
    trained bf16 config loss within 1e-3 and each leaf's distance to the
    f32 gradient at most 1.5 × the plain path's, since bf16's own
    rounding puts two correct bf16 gradients ~2 % apart — then 4
    ``build_step`` train steps (the loss of
    each, the first and warm step seconds, tokens/s, peak GiB) with the
    launch counts zeroed before and read after (one backward launch a
    layer and µbatch, every one on "mma", two forward launches with the
    remat recompute),
    then one more step under ``torch.profiler`` (device busy share, the
    largest device-time entries);
24. DLRM (every field capped at 2 M rows, so that parameters, gradients
    and the Adagrad accumulator fit), FM and xDeepFM (train_batch cut to
    8192 rows) three Adagrad steps each at train_batch; BERT4Rec at its
    published config: serve_p99 and retrieval_cand (2^20 candidates)
    uncut, serve_bulk cut to 32768 rows and train_batch to 2048, three
    AdamW steps; a ``train_loop.run`` on BERT4Rec with a checkpoint
    directory and a fault injected at step 3 (one recovery, to step 2),
    then a second run on the directory that resumes at step 6; every cut
    listed;

then the MoE and MLA LMs:

25. Qwen3-30B-A3B (d 2048, 32 / 4 heads × 128, qk-norm, 128 experts
    top-8 × 768, vocab 151,936) with its depth cut from 48 layers to 8,
    then DeepSeek-V2 (d 5120, 128 MLA heads: kv_lora 512, q_lora 1536,
    q·k 128 + 64, v 128; 160 experts top-6 × 1536 + 2 shared, vocab
    102,400, the first layer dense) cut from 60 layers to 2 (1 dense + 1
    MoE), each at full width in bf16 with seeded weights made on the card
    (``MOE_LM_DEPTH``; f32 master weights and the bf16 copy, 6 bytes a
    parameter, and the first model freed before the second is built):
    ``build_step`` prefill on 4 prompts × 2048 (``lm_batch`` seed 0,
    max_len 2080) and 16 greedy decode steps, the launch counts zeroed
    before and read after (kernel 8 once a layer in prefill, all on
    "mma" — MLA at q·k 192 / v 128 — and Qwen3's decode on "split", the
    absorbed MLA decode none; kernel 5, the router's top-k, once a MoE
    layer and call); the first MoE layer on the prefill's own input with
    kernel 5 equal bit for bit to the same layer with the plain
    selection; kernel 8 at layer 0's q / k / v within one bf16 ulp +
    1e-5 of its plain version (``flash_close``); the same model on the
    plain attention, teacher-forced, with its own selection (the (token,
    MoE layer) pairs whose routed expert set differs, counted; a row
    whose argmax differs where the plain top-2 margin > 0.05 must have
    had its own token rerouted) and with the routing pinned to the kernel
    run's (argmax equal where the margin > 0.05, the max logit diff);
    prefill s, decode ms a
    step, tokens/s, peak GiB, a profile of one prefill and one decode
    step; one ``build_step`` train step of each smoke config (f32: the
    kernels' "simt" routes); kernel 8 timed at the MLA prefill launch on
    its <192, 128> tile beside the <256, 128> tile it ran on before (a
    patched copy of the source, ``PREVIOUS_MLA_DESIGN``, built beside the
    kernels in phase 1 and timed in turns with it: old, new, new, old) and
    ``scaled_dot_product_attention``, kernel 5 at the router shapes (8192
    × 128, m 8; 8192 × 160, m 6) beside ``torch.topk``, and kernel 8b on
    "mma" at MLA width (1 × 128 × 2048, bf16) against its plain version,
    beside the bf16 "simt" route it took before (a patched copy, in
    turns) and SDPA's backward;

then the model-parallel paths, on a one-rank NCCL mesh over ("data",
"model") of shape (1, 1), each against its no-mesh twin on the same
weights:

26. the train steps (``phase_mesh_train``: Llama-3.2-1B, the MoE LMs'
    sharded expert branch, the MoE smoke steps, the recsys steps and
    DLRM serve_p99);
27. LM serving (``phase_mesh_serve``): the meshed ``build_step`` prefill
    and decode plans of Llama-3.2-1B at phase 11's shape (4 × 2048,
    max_len 2080, 16 greedy steps) and of Qwen3-30B-A3B and DeepSeek-V2
    at phase 25's depths (4 × 2048, 8 greedy steps) against the no-mesh
    plans: greedy tokens and expert ids equal, logits within 0.07 with
    bitwise printed, walls and peaks; kernel 8's launches on "mma"
    (prefill) and "split" (decode), kernel 5's once a MoE layer and
    call; and kernel 8's split decode on 2 and 4 sequence slices of
    each Llama layer's cache (rows at kv_len 2049, 1100, 520 and 7, so
    that some slices hold no visible key) merged by their log-sum-exp
    (``merge_by_lse_parts``) against the unsplit kernel: f32 within
    1e-5, bf16 within one bf16 ulp at the partials' scale, no NaN;

and last the GNN family, which runs no kernel of the port (gathers,
small f32 MLPs and fixed-order segment sums in plain PyTorch, as the
reference computes them outside Pallas):

28. EGNN at full width (4 layers, hidden 64, d_out 47; f32, TF32 off)
    through ``build_step`` on its four cells (``phase_gnn``): (a)
    full_graph_sm at full size (2708 nodes and the dummy, 10556 edges
    padded to 11264 by ``pad_edges``) against the port's CPU run from
    the same weights — logits, coordinates, loss, gradients within 1e-4
    of max(1, |x|), the non-finite gradient leaves (the reference's NaN
    at self-loops) equal, one AdamW step — two card runs bitwise, and
    the E(n) check (a rotated, translated input: logits unchanged,
    coordinates moved alike, 1e-4); (b) minibatch_lg on
    ``NeighborSampler(fanouts=(15, 10))``'s subgraph of 1024 seeds
    (169984 × 602) of a synthetic Reddit, its edges cut 10×, the
    sampler's host time apart; (c) ogb_products at 2449029 nodes × 100,
    edges cut to what one card holds; (d) molecule (128 × 30 nodes, 64
    edges), the batched forward against a loop over the graphs within
    1e-5; step walls and peaks; (e) the meshed plans of (a), (b) and
    (d) on the one-rank NCCL mesh against the no-mesh plans, bitwise;
    (f) ``launch.train --arch egnn --smoke --steps 20``, finite losses.

29. The dry run's peak estimates (``launch/dryrun.py``) of phases 23 and
    28's steps against the card's peaks, within [0.90, 1.10], and one
    production-mesh dry run in its own process (``phase_estimates``).
30. The port's four examples through their ``main(argv)`` in this
    process, each with the launch counts zeroed before and read after
    (``phase_examples``): ``torch_quickstart`` (MAE / P / R / F1 equal to
    the reference's CPU printout, ``QUICKSTART_METRICS``; the pcc top-5
    of users 0-2 equal to ``QUICKSTART_TOP5`` up to ties within 1e-5);
    ``torch_serve_recommendations`` exact on ``--backend kernel`` (the
    update refits every row, as the reference's ``pallas`` does), on the
    default backend (the reference's 253 rows recomputed, 771 merged) and
    approx on the kernels, every one of 64 requests answered;
    ``torch_train_cf_movielens`` at its defaults on ``sequential`` and
    on ``ring`` over the one-rank NCCL mesh, equal CSVs but ``fit_s``;
    ``torch_train_lm`` at its defaults (~100 M parameters, 200 steps,
    f32) with a fault at step 120: one restart, the loss falls, kernels
    8 and 8b on ``"simt"``; then ``python -m repro_torch.analysis
    --device cuda``'s checks: exit 0, the widenings of
    ``PRECISION_audit_torch.json``, no kernel build or load in a warm
    window.  Kernels 1-6, 8 and 8b must launch.  A CPU rehearsal sets
    ``EXAMPLE_LM_ARGS``, ``EXAMPLE_LM_CONFIG``, ``EXAMPLE_LM_CKPT_EVERY``
    and ``EXAMPLE_CF_ARGS`` small, replaces ``check`` and calls
    ``phase_examples(torch.device("cpu"))``: only the launch checks fail.
31. DeepSeek-V2 trained at full width (``phase_mla_train``: d 5120, 128
    MLA heads at q·k 192 / v 128, vocab 102,400), its depth cut from 60
    layers to the first, dense one (``MLA_TRAIN_DEPTH``), train_4k's
    4096-token rows with the batch cut to 32 in 2 µbatches of 16, the
    most the dry run puts under 72 GB (``MLA_TRAIN_SHAPE``): (a) one
    step's loss and per-leaf gradients at 1 × 4096 through kernels 8 and
    8b against the plain attention (loss within 1e-3 relative; each bf16
    leaf's distance to the plain attention's f32 gradient at most 1.5 ×
    the plain path's); (b) 2 ``build_step`` AdamW steps, finite losses,
    the warm step's seconds and tokens/s, the peak within 72 GB beside
    the dry run's estimate; (c) the counts zeroed before (b) and read
    after: every forward launch on "mma"'s <192, 128> tile, every
    backward launch on "mma", none on "simt"; a third step profiled.  A
    CPU rehearsal patches ``repro_torch.configs.get_arch`` to the smoke
    config in bf16, sets ``MLA_TRAIN_SHAPE`` and ``MLA_GRAD_ROWS`` small,
    stubs the ``torch.cuda`` calls and ``profile_each`` and replaces
    ``check``: only the launch checks fail.

Then one ``{"kernels": [...]}`` line with times, bounds and launch counts
for all nine kernels, kernel 8's backward, and kernels 8 and 5 again at
phase 25's MLA prefill and router shapes (``flash_attention:mla_prefill``,
``select_topm:router``) and 8b at MLA width (``flash_attention_bwd:mla``);
phase 30's launches are added to the main rows, phase 31's to the MLA
rows.

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the script exits non-zero with no ``ok`` line; without a CUDA
card it exits 2 before printing any result.
"""

from __future__ import annotations

import concurrent.futures
import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM published peaks (dense): HBM bandwidth, f32 on the CUDA cores
# (the CF kernels' f32 inputs), bf16 on the tensor cores (the LM's bf16
# attention inputs) and int8 on the tensor cores (the rerank's int8 route)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12
PEAK_INT8_OPS_PER_S = 1.979e15
TOL = 1e-6
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# kernels 5 and 8 before their redesign (the select's bitonic merge, the
# flash kernel's f32 SIMT tiles for bf16): ms a launch, timed by this
# script on an H100 80GB HBM3 at 700 W (CUDA events; the item-index
# select from its torch.profiler entry); kernels 4 and 6 before theirs
# (the scan's running bitonic merge; the rerank's f32 SIMT tiles with f32
# queries over the union padded to 8192 columns), timed by
# tools/kernel_times.py --only index on the parent tree in the same call
# as this design, on an H100 80GB HBM3 at 700 W
# kernels 2 and 3 before theirs (one 512-item tile a thread block, one
# item a thread; 32 × 32 output tiles with every norm recomputed), on the
# device alone, timed by tools/kernel_times.py --only predict --only
# cluster on the parent tree in the same call as this design, on an H100
# 80GB HBM3 at 700 W
PREVIOUS_MS = {"fused_tile_predict m=1024 k=40 [0,3952)": 0.1771,
               "fused_centroid_distances (6040,256)x(78,256)": 0.0485,
               "select_topm Q=256 L=8192 m=906": 0.9113,
               "select_topm Q=6040 L=3952 m=512": 2.534,
               "flash_attention prefill": 2.9568,
               "flash_attention decode": 0.2644,
               "fused_scan_topm Q=2048 N=6040 P=256 m=906": 2.2792,
               "fused_rerank_scores G=2048 J=3952 pcc": 28.6784}
# phase 6's recall@20, the same with every kernel design so far (exact
# kernels on the same seeded data)
RECALL_U32768 = 0.9489044189453125
BF16_ULP = 2.0 ** -7   # a bf16 x's unit in the last place is ≤ |x|·2⁻⁷
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip smoke check failed: {what}")


def max_diff(a, b) -> float:
    """Max |a − b|, with equal entries (equal infinities too) at 0."""
    if isinstance(a, tuple):
        return max(max_diff(x, y) for x, y in zip(a, b))
    if not a.numel():
        return 0.0
    a, b = a.float(), b.float()
    return float(torch.where(a == b, torch.zeros_like(a),
                             (a - b).abs()).max())


def time_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
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


def time_ms_queued(fn, reps: int = 50) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls that
    are enqueued behind a ~20 ms spin kernel, so a launch shorter than
    the host's work to enqueue it is timed on the device alone (CUDA
    events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_ms_cold(fn, reps: int = 20) -> float:
    """Median device time of ``fn`` over ``reps`` calls with the 50 MB L2
    cache flushed before each (a 512 MB buffer rewritten, then a ~0.2 ms
    spin, just before the start event, so the device is still busy when
    ``fn`` is enqueued even if the host stalls)."""
    flush = torch.empty(2**27, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(400_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_wall_ms(fn, reps: int = 30) -> float:
    """Median host-clock ms of one call of ``fn`` from an idle device to
    its return (what its caller waits for)."""
    fn()
    lat = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        lat.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(lat))


def bound_ms(n_bytes: float, n_ops: float, peak_ops=PEAK_F32_OPS_PER_S):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def rated_terms(rows: torch.Tensor, ids: torch.Tensor,
                w: torch.Tensor) -> int:
    """The (neighbor, item) terms that a weighted sum over the gathered
    rows ``rows[ids]`` needs: the rated elements (> 0) of rows that carry a
    nonzero weight.  An unrated element or a weight-0 slot adds only ±0 to
    num and den, which changes no prediction, so the kernels skip it."""
    per_row = (rows > 0).sum(1)
    return int((per_row[ids.long()] * (w != 0)).sum())


def int_ratings(rng, u, d, density=0.05):
    return torch.from_numpy((rng.integers(1, 6, (u, d))
                             * (rng.random((u, d)) < density))
                            .astype(np.float32))


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_kernels(dev, rng, train_dev):
    """Phase 2: each kernel against its plain version on the card."""
    from repro_torch.core import predict as pr
    from repro_torch.kernels.predict import (fused_tile_predict,
                                             tile_predict_plain)
    from repro_torch.kernels.similarity import (fused_similarity,
                                                similarity_plain)
    err = {"similarity": 0.0, "predict": 0.0}

    def sim_routes(name, ra, rb, max_value):
        """Every measure on both routes, by name: f32 rows → "simt", the
        same values as int8 → "imma", each bit for bit with the plain
        version (0.0 required)."""
        for route, a, b in (("simt", ra, rb),
                            ("imma", ra.to(torch.int8), rb.to(torch.int8))):
            for measure in ("jaccard", "cosine", "pcc", "pcc_sig", "all"):
                before = dict(fused_similarity.routes)
                got = fused_similarity(a, b, measure=measure,
                                       max_value=max_value)
                check(fused_similarity.routes == {
                    k: v + (k == route) for k, v in before.items()},
                    f"similarity {name} {measure} took the {route} route")
                e = max_diff(got, similarity_plain(a, b, measure=measure))
                err["similarity"] = max(err["similarity"], e)
                check(e == 0.0, f"similarity {route} {measure} {name} "
                      f"diff {e}")
            log(f"  similarity {route} (5 measures) {name} max_value "
                f"{max_value} max_abs_diff={err['similarity']!r}")
        torch.cuda.synchronize()

    def signed(rows, d, bound):
        x = rng.integers(-bound, bound + 1, (rows, d)) \
            * (rng.random((rows, d)) < 0.5)
        x[0] = bound                                 # a row at the bound
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    # ragged m, n (off the 128 / 64 / 16 tiles) and D (off 16: padded)
    for m, n, d in ((257, 131, 3952), (1, 33, 17), (129, 65, 3952),
                    (200, 100, 1000), (17, 1, 3)):
        sim_routes(f"({m},{d})x({n},{d})", int_ratings(rng, m, d, 0.3)
                   .to(dev), int_ratings(rng, n, d, 0.3).to(dev), 5)
    # |v| ≤ 15: one u8 square plane; 16: the hi plane joins
    for bound in (15, 16):
        sim_routes(f"(150,1000)x(70,1000) signed", signed(150, 1000, bound),
                   signed(70, 1000, bound), bound)
    # the domain's edge: max_value² · D = 2^24 is taken, one item more
    # raises, as does D = 3952 without max_value (int8's own 128)
    edge = signed(40, 4096, 64)
    edge[1] = 64.0                      # dot(row 0, row 1) = 2^24
    sim_routes("(40,4096)x(40,4096) at max_value² · D = 2^24", edge, edge,
               64)
    for a, kw in ((torch.zeros(3, 4097, dtype=torch.int8, device=dev),
                   {"max_value": 64}),
                  (train_dev[:8].to(torch.int8), {})):
        try:
            fused_similarity(a, a, measure="pcc", **kw)
        except ValueError as exc:
            check("exact domain" in str(exc), "domain error message")
        else:
            check(False, f"int8 similarity at D={a.shape[1]}, {kw} must "
                  f"raise outside the exact domain")
    log("  similarity imma: max_value² · D = 2^24 taken; 2^24 + 4096 and "
        "no max_value at D = 3952 raise")
    # a max_value below the data is caught on the device: counted into
    # the caller's n_bad, or raised by the wrapper
    low = signed(70, 1000, 15)
    low[5, 7], low[9, 999] = 16.0, -16.0
    a8 = low.to(torch.int8)
    n_bad = torch.zeros(1, dtype=torch.int32, device=dev)
    fused_similarity(a8, a8[:33], measure="pcc", max_value=15, n_bad=n_bad)
    check(int(n_bad.item()) == 4, f"rows past max_value 15 counted "
          f"{int(n_bad.item())}, want 4 (rows 5 and 9 of either block)")
    try:
        fused_similarity(a8, a8, measure="pcc", max_value=15)
    except ValueError as exc:
        check("past max_value" in str(exc), "max_value error message")
    else:
        check(False, "int8 similarity with data past max_value must raise")
    log("  similarity imma: data past max_value counted and raised")
    block = train_dev[:1024].contiguous()
    sim_routes(f"{tuple(train_dev.shape)}x{tuple(block.shape)}", train_dev,
               block, 5)

    src = pr.make_gather_source(train_dev)
    means = pr.user_means(train_dev)
    n_users, n_items = train_dev.shape
    for k in (1, 7, 40, 65, 100):
        m = 300
        ids = torch.from_numpy(rng.integers(0, n_users, (m, k))
                               .astype(np.int32)).to(dev)
        w = torch.from_numpy(rng.random((m, k)).astype(np.float32)).to(dev)
        w[::3, -1] = 0.0               # empty (-1) slots: id 0, weight 0
        ids[::3, -1] = 0
        nbm = means[ids.long()].contiguous()
        qm = means[:m].contiguous()
        # ids outside [0, U) contribute nothing: the plain version with
        # that slot at id 0 and weight 0
        bad = ids.clone()
        bad[1::5, k // 2] = n_users + 7
        bad[2::5, 0] = -1
        w_bad = torch.where(bad == ids, w, torch.zeros_like(w)).contiguous()
        ids_ok = torch.where(bad == ids, ids, torch.zeros_like(ids))
        for s, route in ((src, "int8"), (train_dev, "f32")):
            # the whole range (one launch of the path), a full and the
            # ragged last 512-item tile, unaligned ranges (the int8
            # route's byte loads)
            for lo, hi in ((0, n_items), (0, min(512, n_items)),
                           (n_items - n_items % 512 or n_items - 368,
                            n_items),
                           (min(100, n_items - 1), min(1333, n_items)),
                           (min(3, n_items - 1), min(700, n_items))):
                before = dict(fused_tile_predict.routes)
                e = max_diff(fused_tile_predict(s, ids, w, nbm, qm, lo, hi),
                             tile_predict_plain(s, ids, w, nbm, qm, lo, hi))
                check(fused_tile_predict.routes == {
                    key: v + (key == route) for key, v in before.items()},
                    f"tile predict took the {route} route")
                err["predict"] = max(err["predict"], e)
                check(e == 0.0, f"tile predict {route} k={k} [{lo},{hi}) "
                      f"diff {e}")
            e = max_diff(fused_tile_predict(s, bad, w, nbm, qm, 3, 700),
                         tile_predict_plain(s, ids_ok, w_bad, nbm, qm, 3,
                                            700))
            err["predict"] = max(err["predict"], e)
            check(e == 0.0, f"tile predict {route} k={k} bad ids diff {e}")
        log(f"  tile_predict k={k:3d} int8 and f32 routes, 5 item ranges "
            f"and ids outside [0, U) max_abs_diff={err['predict']!r}")
    # the f32 route as the MovieLens-25M recommend runs it: half stars
    # over 59,047 items (not a multiple of 16), a block of 1,024 queries
    # at k 40, one launch over every item; the plain version by 8,192-item
    # ranges, bit for bit
    g = torch.Generator(device=dev).manual_seed(25)
    half = (torch.randint(1, 11, (4096, 59047), generator=g, device=dev)
            .float() / 2)
    half *= torch.rand(half.shape, generator=g, device=dev) < 0.02
    check(pr.make_gather_source(half) is half,
          "a half-star matrix is its own gather source")
    hm = pr.user_means(half)
    ids = torch.randint(0, 4096, (1024, 40), generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.rand((1024, 40), generator=g, device=dev)
    w[::3, -1] = 0.0
    nbm, qm = hm[ids.long()].contiguous(), hm[:1024].contiguous()
    before = fused_tile_predict.routes["f32"]
    got = fused_tile_predict(half, ids, w, nbm, qm, 0, 59047)
    check(fused_tile_predict.routes["f32"] == before + 1,
          "tile predict at 59,047 items took the f32 route")
    for lo in range(0, 59047, 8192):
        hi = min(59047, lo + 8192)
        check(torch.equal(got[:, lo:hi].contiguous().view(torch.int32),
                          tile_predict_plain(half, ids, w, nbm, qm, lo, hi)
                          .view(torch.int32)),
              f"tile predict f32 half stars [{lo},{hi}) bit for bit")
    log("  tile_predict f32 route, half stars 4096 x 59047, 1024 queries "
        "k=40, whole range: bit for bit with the plain version")
    del half, got
    torch.cuda.synchronize()
    return err


def phase_main_path(dev, train, test):
    """Phase 3: the port's main path through its public entry points."""
    from repro_torch.core import metrics
    from repro_torch.core.facade import CFEngine
    from repro_torch.kernels.predict import fused_tile_predict
    from repro_torch.kernels.similarity import fused_similarity
    from repro_torch.serving.engine import BatchingServer

    out = {}
    fused_similarity.launches = 0
    fused_similarity.routes = dict.fromkeys(fused_similarity.routes, 0)
    fused_tile_predict.launches = 0
    fused_tile_predict.routes = dict.fromkeys(fused_tile_predict.routes, 0)
    t0 = time.perf_counter()
    eng = CFEngine(train, measure="pcc", k=40, backend="kernel",
                   device=dev).fit()
    torch.cuda.synchronize()
    out["fit_s"] = time.perf_counter() - t0
    fit_idx, fit_scores = eng.idx.clone(), eng.scores.clone()
    out["fit_routes"] = dict(fused_similarity.routes)
    check(out["fit_routes"]["imma"] == fused_similarity.launches > 0,
          f"every similarity launch of the fit on the int8 route: "
          f"{out['fit_routes']}")

    t0 = time.perf_counter()
    pred = eng.predict()
    mae = float(metrics.mae(pred, torch.from_numpy(test).to(dev)))
    out["predict_s"] = time.perf_counter() - t0
    out["mae"] = mae
    check(tuple(pred.shape) == tuple(train.shape), "predict shape")
    check(bool(torch.isfinite(pred).all()), "finite predictions")
    check(0.3 < mae < 1.5, f"held-out MAE {mae} out of range")
    kernel_pred = pred

    t0 = time.perf_counter()
    rec_s, rec_i = eng.recommend(n=10)
    torch.cuda.synchronize()
    out["recommend_s"] = time.perf_counter() - t0
    check(tuple(rec_i.shape) == (train.shape[0], 10), "recommend shape")
    seen = eng.ratings > 0
    rows = torch.arange(train.shape[0], device=dev)[:, None]
    valid = rec_i >= 0
    check(not bool((seen[rows, rec_i.long().clamp_min(0)] & valid).any()),
          "recommend returned an already-rated item")

    rng = np.random.default_rng(5)
    users = rng.choice(train.shape[0], 16, replace=False)
    uids = np.repeat(users, 4).astype(np.int32)
    iids = rng.integers(0, train.shape[1], uids.size).astype(np.int32)
    vals = rng.integers(0, 6, uids.size).astype(np.float32)
    t0 = time.perf_counter()
    st = eng.update_ratings(uids, iids, vals, oracle_check=True)
    out["update_s"] = time.perf_counter() - t0
    check(st.oracle_ok is True, "update_ratings oracle")

    server = BatchingServer(eng, max_batch=32, topn=10, device=dev)
    server.start()
    req = np.random.default_rng(0).integers(0, train.shape[0], 512)
    t0 = time.perf_counter()
    futs = [server.submit(int(u)) for u in req]
    res = [f.result(timeout=300) for f in futs]
    wall = time.perf_counter() - t0
    server.stop()
    check(all(f.done() for f in futs) and len(res) == 512,
          "every served future resolves")
    _, want = eng.recommend(req, n=10)
    want = want.cpu().numpy()
    for r, u, w in zip(res, req, want):
        check(r.user == int(u) and np.array_equal(r.items, w),
              f"served answer for user {u} equals engine.recommend")
    stats = server.stats()
    out.update(serve_req_per_s=512 / wall, p50_ms=stats["latency_p50_ms"],
               p99_ms=stats["latency_p99_ms"], batches=stats["n_batches"])
    torch.cuda.synchronize()
    out["launches"] = {"similarity": fused_similarity.launches,
                       "predict": fused_tile_predict.launches}
    out["routes"] = dict(fused_similarity.routes)
    out["predict_routes"] = dict(fused_tile_predict.routes)
    check(out["launches"]["similarity"] > 0, "similarity kernel launched")
    check(out["routes"]["imma"] == out["launches"]["similarity"],
          f"every similarity launch of the main path on the int8 route: "
          f"{out['routes']}")
    check(out["launches"]["predict"] > 0, "tile predict kernel launched")
    check(out["predict_routes"]["int8"] == out["launches"]["predict"],
          f"every tile-predict launch of the main path on the int8 route: "
          f"{out['predict_routes']}")
    # a steady fit's wall and device time (torch.profiler)
    out["fit_profile"] = profile_each((("exact fit (steady)", eng.fit),),
                                      n_rows=3)[0]

    # the sequential backend (plain torch.matmul path) on the same input
    seq = CFEngine(train, measure="pcc", k=40, backend="sequential",
                   device=dev).fit()
    check(torch.equal(seq.idx, fit_idx), "kernel vs sequential neighbor ids")
    check(torch.equal(seq.scores, fit_scores),
          "kernel vs sequential neighbor scores")
    check(torch.equal(seq.recommend(n=10)[1], rec_i),
          "kernel vs sequential top-n item ids")
    check(torch.equal(seq.predict().view(torch.int32),
                      kernel_pred.view(torch.int32)),
          "kernel vs sequential predict(), every user and item, bit for bit")
    del kernel_pred
    torch.cuda.synchronize()
    return out, eng


def phase_small_cross_check(dev):
    """A small input through the CPU plain path and the card's kernels."""
    from repro_torch.core.facade import CFEngine
    from repro_torch.data import load_ml1m_synthetic
    small, _, _ = load_ml1m_synthetic(n_users=384, n_items=300, seed=0)
    cpu = CFEngine(small, k=10, block_size=128, device="cpu").fit()
    gpu = CFEngine(small, k=10, block_size=128, device=dev).fit()
    check(torch.equal(cpu.idx, gpu.idx.cpu()), "CPU vs card neighbor ids")
    e = max_diff(cpu.scores, gpu.scores.cpu())
    check(e <= TOL, f"CPU vs card neighbor scores diff {e}")
    check(torch.equal(cpu.recommend(n=10)[1], gpu.recommend(n=10)[1].cpu()),
          "CPU vs card top-n ids")
    return e


def index_wrappers():
    """The approximate index's kernel wrappers, by kernel name."""
    from repro_torch.kernels.cluster import fused_centroid_distances
    from repro_torch.kernels.rerank import fused_rerank_scores
    from repro_torch.kernels.select import fused_scan_topm, select_topm
    return {"cluster": fused_centroid_distances, "scan": fused_scan_topm,
            "select": select_topm, "rerank": fused_rerank_scores}


def zero_counts() -> None:
    """Every kernel wrapper's launch count, and the embedding bag's and
    the flash backward's route counts, set to 0."""
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    for fn in all_wrappers().values():
        fn.launches = 0
    for fn in (embedding_bag, flash_attention_bwd):
        fn.routes = dict.fromkeys(fn.routes, 0)


def all_wrappers():
    """Every kernel wrapper of the port, by kernel name."""
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.predict import fused_tile_predict
    from repro_torch.kernels.similarity import fused_similarity
    from repro_torch.kernels.support import fused_support_scores
    return {"similarity": fused_similarity, "predict": fused_tile_predict,
            **index_wrappers(), "support": fused_support_scores,
            "flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "embedding_bag": embedding_bag}


def unit_rows(rng, n, d, dev):
    x = rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return torch.from_numpy(x).to(dev)


def check_topm(name, got, want, err, key):
    """Ids equal, values within TOL; returns the max value diff."""
    check(torch.equal(got[1], want[1]), f"{name} ids equal")
    e = max_diff(got[0], want[0])
    err[key] = max(err[key], e)
    check(e <= TOL, f"{name} values diff {e}")
    log(f"  {name} ids equal, max_abs_diff={e!r}")


def phase_index_kernels(dev, rng, train_dev):
    """Phase 4: kernels 3-6 against their plain versions on the card."""
    from repro_torch.kernels.cluster import (centroid_distances_plain,
                                             fused_centroid_distances)
    from repro_torch.kernels.rerank import (fused_rerank_scores,
                                            rerank_scores_plain)
    from repro_torch.kernels.select import (fused_scan_topm,
                                            scan_topm_plain, select_topm,
                                            select_topm_twin)
    err = {"cluster": 0.0, "scan": 0.0, "select": 0.0, "rerank": 0.0}
    for (m, d), n in (((257, 256), 78), ((1, 17), 33), ((6040, 256), 78),
                      ((301, 17), 97), ((2048, 512), 182), ((64, 1), 1)):
        x, c = unit_rows(rng, m, d, dev), unit_rows(rng, n, d, dev)
        full = fused_centroid_distances(x, c)
        e = max_diff(full, centroid_distances_plain(x, c))
        err["cluster"] = max(err["cluster"], e)
        check(e == 0.0, f"centroid distances ({m},{d})x({n},{d}) diff {e}")
        rows = torch.arange(0, m, 3, device=dev)[:16]
        check(torch.equal(fused_centroid_distances(x[rows].contiguous(), c),
                          full[rows]),
              f"centroid distances batch invariance ({m},{d})")
        log(f"  centroid_distances ({m},{d})x({n},{d}) max_abs_diff={e!r}; "
            f"row subset bitwise equal to the full call")
    # kernels 4/5: the reference Pallas kernel's failing shape, duplicated
    # pool rows (exact ties), m > N, P not a multiple of 4, the approx
    # path's block (phase 5) and phase 6's; values bit for bit
    for q_n, n, p, m, dup in ((130, 257, 33, 17, 1), (21, 240, 12, 25, 8),
                              (9, 40, 8, 999, 1), (2048, 6040, 256, 906, 1),
                              (2048, 32768, 512, 655, 1)):
        q = unit_rows(rng, q_n, p, dev)
        prox = unit_rows(rng, n // dup, p, dev).repeat_interleave(dup, 0)
        prox = prox.contiguous()
        q_ids = torch.arange(q_n, dtype=torch.int32, device=dev)
        q_ids[::7] = n                               # padding queries
        got = fused_scan_topm(q, prox, q_ids, m=m)
        want = scan_topm_plain(q, prox, q_ids, min(m, n))
        check(torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)),
              f"scan_topm Q={q_n} N={n} P={p} m={m}: values bit for bit")
        check_topm(f"scan_topm Q={q_n} N={n} P={p} m={m} dup={dup}", got,
                   want, err, "scan")
    try:
        fused_scan_topm(q[:2], prox[:20000], q_ids[:2], m=16385)
        check(False, "scan past the select's domain raises")
    except ValueError as exc:
        log(f"  scan_topm m=16385: raises ({exc})")
    # (1024, 17770, 10) and (1024, 59047, 10) are the bulk recommend's
    # user blocks at Netflix and MovieLens-25M width (the staged and the
    # unstaged branch), their scores clamped to [1, 5] as predictions are,
    # so that ties at 5.0 cross the top-10 cut
    for q_n, n, m in ((130, 257, 17), (256, 3000, 906), (7, 30, 64),
                      (9, 300, 1), (9, 300, 300), (9, 300, 280),
                      (3, 40000, 700), (1024, 17770, 10),
                      (1024, 59047, 10)):
        sc = torch.from_numpy(
            rng.integers(-40, 41, (q_n, n)).astype(np.float32) / 8).to(dev)
        if q_n == 1024:
            sc.clamp_(1.0, 5.0)
            check(bool(((sc == 5.0).sum(1) > m).all()),
                  "every row's top 10 lies inside the ties at 5.0")
        sc[torch.rand(sc.shape, device=dev) < 0.1] = float("-inf")
        sc[1] = float("-inf")                        # an all -inf row
        sc[2, ::3] = -0.0                            # ±0.0 ties
        sc[2, 1::3] = 0.0
        none = torch.full((q_n,), -1, dtype=torch.int32, device=dev)
        got = select_topm(sc, none, m=m)
        want = select_topm_twin(sc, none, m=m)
        check(bool((got[1][1] == n).all()), "all -inf row carries sentinel")
        check(torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)),
              f"select_topm Q={q_n} N={n} m={m}: values equal bit for bit")
        check_topm(f"select_topm Q={q_n} N={n} m={m} (ties, ±0, -inf rows)",
                   got, want, err, "select")
    # kernel 6 on both routes: "simt" (f32 queries; f32 or int8
    # candidates) and "imma" (int8 × int8: training rows, values up to 127
    # at J = 300 for the squares' hi halves, all-zero rows, G and Kc off
    # the tiles), every measure, β 50 and 7.3; values bit for bit
    big = torch.from_numpy(rng.integers(-128, 128, (80, 300))
                           * (rng.random((80, 300)) < 0.5)).to(dev)
    big[3] = 0
    cases = [(train_dev[:37], train_dev[100:231], "simt", None),
             (train_dev[:37], train_dev[100:231].to(torch.int8), "simt",
              None),
             (train_dev[:130].to(torch.int8),
              train_dev[300:457].to(torch.int8), "imma", 5),
             (big[:33].to(torch.int8), big[33:].to(torch.int8), "imma", 128)]
    for q, c, route, bound in cases:
        q, c = q.contiguous(), c.contiguous()
        cf = c.float()
        norms = torch.sqrt((cf.double() ** 2).sum(1)).float()
        counts = (cf > 0).sum(1).float()
        for measure in ("jaccard", "cosine", "pcc", "pcc_sig"):
            for beta in (50.0, 7.3):
                before = dict(fused_rerank_scores.routes)
                got = fused_rerank_scores(q, c, norms, counts,
                                          measure=measure, beta=beta,
                                          max_value=bound)
                want = rerank_scores_plain(q, c, norms, counts,
                                           measure=measure, beta=beta)
                check(fused_rerank_scores.routes[route] == before[route] + 1,
                      f"rerank {route} route taken")
                check(torch.equal(got.view(torch.int32),
                                  want.view(torch.int32)),
                      f"rerank {measure} {route} {tuple(q.shape)}x"
                      f"{tuple(c.shape)} beta {beta}: bit for bit")
                err["rerank"] = max(err["rerank"], max_diff(got, want))
        log(f"  rerank_scores {route} {str(q.dtype)[6:]}x{str(c.dtype)[6:]} "
            f"{tuple(q.shape)}x{tuple(c.shape)}, 4 measures, beta 50/7.3: "
            f"bit for bit")
    try:
        fused_rerank_scores(*(t.to(torch.int8) for t in (train_dev[:4],
                                                         train_dev[4:9])),
                            norms[:5], counts[:5])
        check(False, "int8 rerank outside its exact domain raises")
    except ValueError as exc:
        log(f"  rerank int8 at J=3952 without max_value: raises ({exc})")
    torch.cuda.synchronize()
    return err


def staged_vs_fused(ix, ratings, means, *, k, measure):
    """The index's staged pipeline (the degradation ladder's query mode:
    the scan kernel, shortlists through the host, the grouped rerank
    kernel) against its fused chain, every user, on the same state: ids
    and scores bit for bit.  Returns both walls, the staged query's
    kernel launches (4 and 6 must be > 0, every rerank launch on the
    "imma" route) and the staged ids."""
    wrappers = index_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    wrappers["rerank"].routes.update(imma=0, simt=0)
    out = {}
    ix.query_mode_override = "staged"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_st, i_st = ix.query(ratings, means, k=k, measure=measure)
    torch.cuda.synchronize()
    out["staged_s"] = time.perf_counter() - t0
    lq = ix.last_query
    out["staged_split_s"] = (lq.seconds_shortlist, lq.seconds_rerank)
    check((lq.query_mode, lq.scan_mode, lq.rerank_mode)
          == ("staged", "kernel", "grouped"),
          f"staged query ran the scan kernel and the grouped rerank "
          f"({lq.query_mode}, {lq.scan_mode}, {lq.rerank_mode})")
    out["launches"] = {name: fn.launches for name, fn in wrappers.items()}
    out["rerank_routes"] = dict(wrappers["rerank"].routes)
    ix.query_mode_override = None
    t0 = time.perf_counter()
    s_fu, i_fu = ix.query(ratings, means, k=k, measure=measure)
    torch.cuda.synchronize()
    out["fused_s"] = time.perf_counter() - t0
    check(ix.last_query.query_mode == "fused", "fused query ran")
    check(out["launches"]["scan"] > 0 and out["launches"]["rerank"] > 0,
          f"kernels 4 and 6 launched on the staged path "
          f"({out['launches']})")
    check(out["rerank_routes"]["imma"] == out["launches"]["rerank"],
          f"every staged rerank launch took the int8 route "
          f"({out['rerank_routes']})")
    check(torch.equal(i_st, i_fu) and torch.equal(s_st, s_fu),
          f"staged == fused, ids and scores bit for bit "
          f"({ratings.shape[0]} users)")
    out["ids"] = i_st
    return out


def phase_approx(dev, train):
    """Phase 5: the approx-neighbour path through the public entry points,
    then the same engine on the plain versions."""
    import dataclasses
    from repro_torch.core.facade import CFEngine
    from repro_torch.index import ClusteredIndex, IndexConfig
    from repro_torch.index import clustered as tcl
    from repro_torch.kernels.predict import fused_tile_predict
    from repro_torch.kernels.similarity import fused_similarity
    from repro_torch.serving.engine import BatchingServer

    wrappers = index_wrappers()
    out = {}
    for fn in (fused_similarity, fused_tile_predict, *wrappers.values()):
        fn.launches = 0
    wrappers["rerank"].routes.update(imma=0, simt=0)
    t0 = time.perf_counter()
    eng = CFEngine(train, measure="pcc", k=40, backend="kernel",
                   neighbor_mode="approx", device=dev).fit()
    torch.cuda.synchronize()
    out["fit_s"] = time.perf_counter() - t0
    ix = eng.index
    fitted = {"idx": eng.idx.clone(), "scores": eng.scores.clone(),
              "state": {k: np.array(v) for k, v in ix.state().items()}}
    lq = ix.last_query
    out["query"] = {"rerank_fraction": lq.rerank_fraction,
                    "seconds_shortlist": lq.seconds_shortlist,
                    "seconds_rerank": lq.seconds_rerank,
                    "seconds_total": lq.seconds_total,
                    "scan_mode": lq.scan_mode, "n_reranked": lq.n_reranked}
    out["config"] = {"n_clusters": ix.n_clusters, "n_probe": ix.n_probe,
                     "spill": ix.spill_ids.shape[1],
                     "project_dim": ix.proxies.shape[1],
                     "max_rerank": ix._max_rerank(40)}
    check(tuple(eng.idx.shape) == (train.shape[0], 40), "approx cache shape")
    ok = eng.idx >= 0
    check(bool(torch.isfinite(eng.scores[ok]).all()), "finite scores")
    check(lq.scan_mode == "kernel", f"scan mode {lq.scan_mode}")

    t0 = time.perf_counter()
    out["recall"] = eng.recall_vs_exact(sample=1024)
    out["recall_s"] = time.perf_counter() - t0
    check(0.0 < out["recall"] <= 1.0, f"recall {out['recall']}")

    cfg_c = dataclasses.replace(ix.cfg, shortlist_scan_mode="cluster")
    users = np.arange(1024)
    ix_c = ClusteredIndex(cfg_c).load_state(fitted["state"], device=dev)
    t0 = time.perf_counter()
    s_c, i_c = ix_c.query(eng.ratings, eng.means, users, k=40,
                          measure="pcc", n_probe=4)
    torch.cuda.synchronize()
    lq_c = ix_c.last_query
    out["cluster_query"] = {"seconds": time.perf_counter() - t0,
                            "scan_mode": lq_c.scan_mode,
                            "rerank_fraction": lq_c.rerank_fraction}
    check(lq_c.scan_mode == "cluster", "cluster-restricted scan ran")

    rng = np.random.default_rng(5)
    uids = np.repeat(rng.choice(train.shape[0], 16, replace=False), 4)
    iids = rng.integers(0, train.shape[1], uids.size)
    vals = rng.integers(0, 6, uids.size).astype(np.float32)
    t0 = time.perf_counter()
    st = eng.update_ratings(uids.astype(np.int32), iids.astype(np.int32),
                            vals, oracle_check=True)
    out["update_s"] = time.perf_counter() - t0
    check(st.oracle_ok is True, "approx update_ratings oracle")
    out["refold"] = dataclasses.asdict(ix.last_refold)

    server = BatchingServer(eng, max_batch=32, topn=10, device=dev)
    server.start()
    req = np.random.default_rng(1).integers(0, train.shape[0], 256)
    t0 = time.perf_counter()
    futs = [server.submit(int(u)) for u in req]
    res = [f.result(timeout=300) for f in futs]
    wall = time.perf_counter() - t0
    server.stop()
    _, want = eng.recommend(req, n=10)
    want = want.cpu().numpy()
    for r, u, w in zip(res, req, want):
        check(r.user == int(u) and np.array_equal(r.items, w),
              f"approx served answer for user {u} equals engine.recommend")
    stats = server.stats()
    out.update(serve_req_per_s=256 / wall, p50_ms=stats["latency_p50_ms"],
               p99_ms=stats["latency_p99_ms"])
    torch.cuda.synchronize()
    out["launches"] = {k: fn.launches for k, fn in wrappers.items()}
    out["rerank_routes"] = dict(wrappers["rerank"].routes)
    for name, n in out["launches"].items():
        check(n > 0, f"{name} kernel launched on the approx path")
    check(out["rerank_routes"]["imma"] == out["launches"]["rerank"],
          f"every rerank launch of the approx path took the int8 route "
          f"({out['rerank_routes']})")
    out["staged"] = staged_vs_fused(ix, eng.ratings, eng.means, k=40,
                                    measure="pcc")
    del out["staged"]["ids"]

    # the same engine on the plain versions (use_kernel=False), on the card
    t0 = time.perf_counter()
    plain = CFEngine(train, measure="pcc", k=40, backend="kernel",
                     neighbor_mode="approx", device=dev,
                     index_cfg=dataclasses.replace(ix.cfg, use_kernel=False)
                     ).fit()
    torch.cuda.synchronize()
    out["plain_fit_s"] = time.perf_counter() - t0
    pst = plain.index.state()
    for key in ("spill_ids", "spill_dist", "centroids", "proxies", "counts"):
        check(np.array_equal(pst[key], fitted["state"][key]),
              f"kernel vs plain index: {key} equal")
    check(torch.equal(plain.idx, fitted["idx"]), "kernel vs plain ids")
    check(torch.equal(plain.scores, fitted["scores"]),
          "kernel vs plain scores")
    n = train.shape[0]
    q_ids = torch.arange(2048, dtype=torch.int32, device=dev)
    m = min(ix._max_rerank(40), n)
    prox = torch.from_numpy(fitted["state"]["proxies"]).to(dev)
    sk = tcl._fused_scan_pool(prox, q_ids, m=m, use_kernel=True)
    sp = tcl._fused_scan_pool(prox, q_ids, m=m, use_kernel=False)
    check(torch.equal(sk[1], sp[1]), "kernel vs plain shortlists (block 0)")
    ix_cp = ClusteredIndex(dataclasses.replace(cfg_c, use_kernel=False)
                           ).load_state(fitted["state"], device=dev)
    s_cp, i_cp = ix_cp.query(plain.ratings, plain.means, users, k=40,
                             measure="pcc", n_probe=4)
    check(torch.equal(i_cp, i_c) and torch.equal(s_cp, s_c),
          "kernel vs plain cluster-restricted query")
    twice = CFEngine(train, measure="pcc", k=40, backend="kernel",
                     neighbor_mode="approx", device=dev).fit()
    check(torch.equal(twice.index.centroids,
                      torch.from_numpy(fitted["state"]["centroids"]).to(dev)),
          "two k-means fits give identical centroids")
    check(torch.equal(twice.idx, fitted["idx"]), "two fits: same neighbors")
    torch.cuda.synchronize()
    return out, eng


def phase_scale(dev):
    """Phase 6: the index at U = 32768 (BENCH_index.json's
    index_cosine_U32768 row) against the exact kernel-backend top-k."""
    from repro_torch.core.facade import CFEngine
    from repro_torch.core.similarity import user_stats
    from repro_torch.data import load_ml1m_synthetic
    from repro_torch.index import ClusteredIndex, IndexConfig
    from repro_torch.kernels.rerank import fused_rerank_scores
    out = {}
    t0 = time.perf_counter()
    train, _, _ = load_ml1m_synthetic(n_users=32768, n_items=3952, seed=0)
    out["data_s"] = time.perf_counter() - t0
    out["ratings"] = int((train > 0).sum())
    r = torch.from_numpy(train).to(dev)
    del train
    out["matrix"] = r
    means = user_stats(r)[2]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ix = ClusteredIndex(IndexConfig(seed=0, features="raw",
                                    rerank_frac=0.02, project_dim=512))
    t0 = time.perf_counter()
    ix.fit(r, means)
    torch.cuda.synchronize()
    out["fit_s"] = time.perf_counter() - t0
    fused_rerank_scores.launches = 0
    fused_rerank_scores.routes.update(imma=0, simt=0)
    t0 = time.perf_counter()
    _, got_i = ix.query(r, means, k=20, measure="cosine")
    torch.cuda.synchronize()
    out["query_s"] = time.perf_counter() - t0
    out["rerank_routes"] = dict(fused_rerank_scores.routes)
    check(fused_rerank_scores.launches > 0
          and out["rerank_routes"]["imma"] == fused_rerank_scores.launches,
          f"every rerank launch of the U=32768 query took the int8 route "
          f"({fused_rerank_scores.launches} launches, "
          f"{out['rerank_routes']})")
    lq = ix.last_query
    out["query"] = {"rerank_fraction": lq.rerank_fraction,
                    "seconds_shortlist": lq.seconds_shortlist,
                    "seconds_rerank": lq.seconds_rerank,
                    "scan_mode": lq.scan_mode}
    out["n_clusters"], out["n_probe"] = ix.n_clusters, ix.n_probe
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    exact = CFEngine(r, measure="cosine", k=20, backend="kernel",
                     device=dev).fit()
    torch.cuda.synchronize()
    out["exact_s"] = time.perf_counter() - t0
    ex = exact.idx
    hits = (ex[:, :, None] == got_i[:, None, :]).any(-1) & (ex >= 0)
    out["recall"] = float(hits.sum()) / max(int((ex >= 0).sum()), 1)
    check(out["recall"] >= 0.94, f"recall@20 {out['recall']} < 0.94")
    check(out["recall"] == RECALL_U32768,
          f"recall@20 {out['recall']!r} is the earlier designs' "
          f"{RECALL_U32768!r} (the kernels are exact)")
    # the staged pipeline, as every BENCH_index.json row was measured
    st = staged_vs_fused(ix, r, means, k=20, measure="cosine")
    hits = (ex[:, :, None] == st.pop("ids")[:, None, :]).any(-1) & (ex >= 0)
    st["recall"] = float(hits.sum()) / max(int((ex >= 0).sum()), 1)
    check(st["recall"] == RECALL_U32768,
          f"staged recall@20 {st['recall']!r} is {RECALL_U32768!r}")
    out["staged"] = st
    check(bool(torch.isfinite(exact.scores).all()), "finite exact scores")
    torch.cuda.synchronize()
    return out


def support_args(rng, b, k, u, i, dev, masked=False):
    """Random support-scorer operands: (U, I) deviation and mask tables,
    (b, k) clipped ids and masked weights, (b,) query means."""
    d = (rng.normal(size=(u, i)).astype(np.float32)
         * (rng.random((u, i)) < 0.3))
    m = (d != 0).astype(np.float32)
    ids = rng.integers(0, u, (b, k)).astype(np.int32)
    w = (rng.random((b, k)) * (rng.random((b, k)) < 0.8)).astype(np.float32)
    if masked:
        w[1::2] = 0.0                               # all-masked rows
    qm = rng.uniform(2, 4, b).astype(np.float32)
    return tuple(torch.from_numpy(x).to(dev) for x in (d, m, ids, w, qm))


def chunk_operands(eng):
    """The support scorer's operands for every user of an engine, as the
    item index builds them: the padded (U, I') tables (the "table"
    route's), the int8 rating matrix (the "int8" route's, with the
    means), and the masked weights / clipped ids of the neighbor cache."""
    from repro_torch.kernels.support import support_tables, support_width
    ratings, scores, idx, means = eng.snapshot()
    tbl = support_tables(ratings, means, support_width(ratings.shape[1]))
    safe = torch.where(idx >= 0, idx, 0).to(torch.int32).contiguous()
    w = torch.where((scores > 0) & (idx >= 0), scores,
                    torch.zeros_like(scores)).contiguous()
    return tbl, ratings.to(torch.int8), safe, w, means.contiguous()


def support_routes(name, r8, tables, rest, want):
    """The support scorer on both routes by name — "int8" from the int8
    ratings and means, "table" from the tables of the same data — each
    bit for bit with ``want`` (0.0 required); returns the int8 route's
    output and the larger diff."""
    from repro_torch.kernels.support import fused_support_scores
    outs, err = {}, 0.0
    for route, ops in (("int8", r8), ("table", tables)):
        before = dict(fused_support_scores.routes)
        outs[route] = fused_support_scores(*ops, *rest)
        check(fused_support_scores.routes == {
            k: v + (k == route) for k, v in before.items()},
            f"support {name} took the {route} route")
        e = max_diff(outs[route], want)
        err = max(err, e)
        check(e == 0.0, f"support {route} route {name} diff {e}")
    return outs["int8"], err


def phase_support_kernel(dev, rng, eng):
    """Phase 7: the support kernel on both routes against its plain
    versions on the card, and the support score against the tile-predict
    kernel (identity)."""
    from repro_torch.core import predict as pr
    from repro_torch.kernels.support import (fused_support_scores,
                                             support_scores_int8_plain,
                                             support_scores_plain,
                                             support_tables, support_width)
    err = 0.0
    for b, k, u, i, masked in ((1, 40, 300, 3952, False),
                               (5, 7, 40, 130, True), (1, 1, 17, 7, False),
                               (33, 40, 300, 1024, True),
                               (257, 40, 6040, 4096, False),
                               (2, 12, 50, 513, False)):
        # the table route on random tables
        args = support_args(rng, b, k, u, i, dev, masked)
        got = fused_support_scores(*args)
        e = max_diff(got, support_scores_plain(*args))
        err = max(err, e)
        check(e == 0.0, f"support ({b},{k},{u},{i}) masked={masked} diff {e}")
        if masked:
            check(torch.equal(got[1::2], args[4][1::2, None].clamp(1, 5)
                              .expand_as(got[1::2])),
                  "all-masked rows fall back to the query mean")
        # both routes on integer ratings and their users' means
        r8 = int_ratings(rng, u, i, 0.3).to(dev, torch.int8)
        means = torch.from_numpy(rng.uniform(2, 4, u).astype(np.float32)) \
            .to(dev)
        rest = args[2:]
        want = support_scores_int8_plain(r8, means, *rest)
        got8, e8 = support_routes(
            f"b={b} k={k} U={u} I={i}", (r8, means),
            support_tables(r8, means, support_width(i)), rest, want)
        err = max(err, e8)
        if masked:
            check(torch.equal(got8[1::2], args[4][1::2, None].clamp(1, 5)
                              .expand_as(got8[1::2])),
                  "int8 route: all-masked rows fall back to the query mean")
        log(f"  support_scores b={b} k={k} U={u} I'={i} "
            f"{'masked rows ' if masked else ''}table route on random "
            f"tables max_abs_diff={e!r}; int8 and table routes on integer "
            f"ratings max_abs_diff={e8!r}")
    (dev_t, msk_t), r8, safe, w, means = chunk_operands(eng)
    rest = (safe, w, means)
    got, e = support_routes("at the 6040-user chunk", (r8, means),
                            (dev_t, msk_t), rest,
                            support_scores_plain(dev_t, msk_t, *rest))
    err = max(err, e)
    ratings, scores, idx, _ = eng.snapshot()
    exact = pr.predict_from_neighbors_blocked(
        ratings, scores, idx, means=means, item_block=512,
        gather_src=pr.make_gather_source(ratings), use_kernel=True)
    n_items = ratings.shape[1]
    check(torch.equal(got[:, :n_items], exact),
          "support kernel == tile-predict kernel (exact prediction)")
    log(f"  support_scores at the {tuple(ratings.shape)} chunk (I'="
        f"{dev_t.shape[1]}, k={safe.shape[1]}): int8 and table routes "
        f"max_abs_diff={e!r} against the plain version; equal bit for bit "
        f"to predict_from_neighbors_blocked(use_kernel=True)")
    torch.cuda.synchronize()
    return err


def phase_recommend(dev, train):
    """Phase 8: the approx-recommend path through the public entry
    points, then the item index on the plain versions."""
    from repro_torch.core.facade import CFEngine
    from repro_torch.index import ItemClusteredIndex, ItemIndexConfig
    from repro_torch.serving.engine import BatchingServer, DegradationLadder
    from repro_torch.kernels.support import fused_support_scores
    wrappers = all_wrappers()
    out = {}
    for fn in wrappers.values():
        fn.launches = 0
    fused_support_scores.routes = dict.fromkeys(fused_support_scores.routes,
                                                0)
    t0 = time.perf_counter()
    eng = CFEngine(train, measure="pcc", k=40, backend="kernel",
                   recommend_mode="approx", device=dev).fit()
    torch.cuda.synchronize()
    out["fit_s"] = time.perf_counter() - t0
    ix = eng.item_index
    out["config"] = {"n_clusters": ix.n_clusters, "n_probe": ix.n_probe,
                     "project_dim": ix.proxies.shape[1],
                     "shortlist": ix.cfg.shortlist,
                     "scorer": ix._shortlist_mode()}
    t0 = time.perf_counter()
    s_ap, i_ap = eng.recommend(n=10)
    torch.cuda.synchronize()
    out["approx_s"] = time.perf_counter() - t0
    out["rerank_fraction"] = ix.last_recommend.rerank_fraction
    t0 = time.perf_counter()
    s_ex, i_ex = eng.recommend(n=10, mode="exact")
    torch.cuda.synchronize()
    out["exact_s"] = time.perf_counter() - t0
    check(torch.equal(i_ap, i_ex) and torch.equal(s_ap, s_ex),
          "approx recommend (shortlist 512) == exact, bitwise")
    t0 = time.perf_counter()
    s64, i64 = eng.recommend(n=10, shortlist=64)
    torch.cuda.synchronize()
    out["approx64_s"] = time.perf_counter() - t0
    check(torch.equal(i64, i_ex) and torch.equal(s64, s_ex),
          "approx recommend (shortlist 64) == exact, bitwise")
    t0 = time.perf_counter()
    out["recall"] = eng.recommend_recall_vs_exact(sample=256)
    out["recall_s"] = time.perf_counter() - t0
    check(out["recall"] == 1.0, f"recommend recall {out['recall']}")

    rng = np.random.default_rng(5)
    uids = np.repeat(rng.choice(train.shape[0], 16, replace=False), 4)
    iids = rng.integers(0, train.shape[1], uids.size)
    vals = rng.integers(0, 6, uids.size).astype(np.float32)
    t0 = time.perf_counter()
    st = eng.update_ratings(uids.astype(np.int32), iids.astype(np.int32),
                            vals, oracle_check=True)
    out["update_s"] = time.perf_counter() - t0
    check(st.oracle_ok is True, "approx-recommend update_ratings oracle")
    lr = ix.last_refold
    out["refold"] = {"n_touched": lr.n_touched,
                     "n_reassigned": lr.n_reassigned,
                     "n_full_rows": lr.n_full_rows,
                     "caches_patched": lr.caches_patched,
                     "profile_refold": lr.profile_refold}
    # the scorer's int8 route reads the patched gather source: no
    # tables are built or patched
    check(lr.caches_patched == 1 and ix._support_dense_cache is None,
          "gather source patched, no scorer tables")
    s_ap, i_ap = eng.recommend(n=10)
    s_ex, i_ex = eng.recommend(n=10, mode="exact")
    check(torch.equal(i_ap, i_ex) and torch.equal(s_ap, s_ex),
          "approx == exact after the update, bitwise")

    server = BatchingServer(eng, max_batch=32, topn=10, device=dev,
                            ladder=DegradationLadder())
    server.start()
    req = np.random.default_rng(2).integers(0, train.shape[0], 256)
    t0 = time.perf_counter()
    futs = [server.submit(int(u)) for u in req]
    res = [f.result(timeout=300) for f in futs]
    wall = time.perf_counter() - t0
    server.stop()
    _, want = eng.recommend(req, n=10)
    want = want.cpu().numpy()
    seen = (eng.ratings > 0).cpu().numpy()
    for r, u, w in zip(res, req, want):
        check(r.user == int(u) and np.array_equal(r.items, w),
              f"approx-recommend served answer for user {u} equals "
              f"engine.recommend")
        check(not seen[u, r.items[r.items >= 0]].any(),
              f"served answer for user {u} holds no rated item")
    stats = server.stats()
    out.update(serve_req_per_s=256 / wall, p50_ms=stats["latency_p50_ms"],
               p99_ms=stats["latency_p99_ms"], health=stats["health"])
    torch.cuda.synchronize()
    out["launches"] = {k: fn.launches for k, fn in wrappers.items()}
    for name in ("cluster", "select", "support"):
        check(out["launches"][name] > 0,
              f"{name} kernel launched on the approx-recommend path")
    out["support_routes"] = dict(fused_support_scores.routes)
    check(out["support_routes"]["int8"] == out["launches"]["support"],
          f"every support launch on the int8 route: {out['support_routes']}")

    # the item index on the plain versions (use_kernel=False), on the card
    t0 = time.perf_counter()
    plain = CFEngine(eng.ratings, measure="pcc", k=40, backend="kernel",
                     recommend_mode="approx", device=dev,
                     item_index_cfg=ItemIndexConfig(use_kernel=False)).fit()
    torch.cuda.synchronize()
    out["plain_fit_s"] = time.perf_counter() - t0
    cold = ItemClusteredIndex(ItemIndexConfig()).fit(eng.ratings, eng.means)
    pst, cst = plain.item_index.state(), cold.state()
    for key in ("proxies", "centroids", "spill_ids", "spill_dist", "counts",
                "profiles", "has_pos"):
        check(np.array_equal(pst[key], cst[key]),
              f"kernel vs plain item index: {key} equal")
    t0 = time.perf_counter()
    s_p, i_p = plain.recommend(n=10)
    torch.cuda.synchronize()
    out["plain_approx_s"] = time.perf_counter() - t0
    check(torch.equal(i_p, i_ex) and torch.equal(s_p, s_ex),
          "plain item index recommend == exact, bitwise")
    check(torch.equal(plain.recommend(n=10, shortlist=64)[1], i_ex),
          "plain item index recommend (shortlist 64) == exact")
    torch.cuda.synchronize()
    return out, eng


def phase_recommend_scale(dev, r):
    """Phase 9: BENCH_recommend.json's recommend_cosine_U32768 row on the
    scale phase's matrix: approx against exact recommend, recall@10."""
    from repro_torch.core.facade import CFEngine
    from repro_torch.index import IndexConfig, ItemIndexConfig
    out = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = CFEngine(r, measure="cosine", k=40, backend="kernel",
                   neighbor_mode="approx",
                   index_cfg=IndexConfig(seed=0, features="raw",
                                         rerank_frac=0.03, project_dim=384),
                   recommend_mode="approx",
                   item_index_cfg=ItemIndexConfig(seed=0, shortlist=64),
                   device=dev).fit()
    torch.cuda.synchronize()
    out["fit_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.item_index.fit(eng.ratings, eng.means)      # its share of the fit
    torch.cuda.synchronize()
    out["item_fit_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_ex, i_ex = eng.recommend(n=10, mode="exact")
    torch.cuda.synchronize()
    out["exact_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_ap, i_ap = eng.recommend(n=10)
    torch.cuda.synchronize()
    out["approx_s"] = time.perf_counter() - t0
    out["rerank_fraction"] = eng.item_index.last_recommend.rerank_fraction
    ex, ap = i_ex.cpu().numpy(), i_ap.cpu().numpy()
    hits = total = 0
    for row in range(ex.shape[0]):
        ref = set(int(j) for j in ex[row] if j >= 0)
        hits += len(ref & set(int(j) for j in ap[row]))
        total += len(ref)
    out["recall"] = hits / max(total, 1)
    out["bitwise"] = bool(torch.equal(i_ap, i_ex)
                          and torch.equal(s_ap, s_ex))
    out["n_item_clusters"] = eng.item_index.n_clusters
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    check(out["recall"] == 1.0, f"recall@10 {out['recall']} at U=32768")
    torch.cuda.synchronize()
    return out


def phase_select_item_timing(dev, eng):
    """Phase 12 (kernel 5 at its second path shape): the item index's
    select over the support scores of one 6040-user chunk (seen items
    −inf), m = the default shortlist, beside ``torch.topk``."""
    from repro_torch.kernels.select import select_topm, select_topm_twin
    from repro_torch.kernels.support import fused_support_scores
    _, r8, safe, w, means = chunk_operands(eng)
    ratings = eng.snapshot()[0]
    n_items = ratings.shape[1]
    sc = fused_support_scores(r8, means, safe, w, means)[:, :n_items]
    sc = sc.masked_fill(ratings > 0, float("-inf")).contiguous()
    q_n = sc.shape[0]
    m = min(eng.item_index.cfg.shortlist, n_items)
    none = torch.full((q_n,), -1, dtype=torch.int32, device=dev)
    got, want = select_topm(sc, none, m=m), select_topm_twin(sc, none, m=m)
    check(torch.equal(got[1], want[1])
          and torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)),
          "select at the item index's shape: ids and values bit for bit")
    bound, by = bound_ms(q_n * n_items * 4.0 + q_n * 4.0 + q_n * m * 8.0,
                         float(q_n * n_items))
    out = {"ms": time_ms_queued(lambda: select_topm(sc, none, m=m)),
           "call_ms": time_ms(lambda: select_topm(sc, none, m=m), reps=20),
           "plain_ms": time_ms(lambda: select_topm_twin(sc, none, m=m),
                               reps=5),
           "library_ms": time_ms_queued(lambda: torch.topk(sc, m)),
           "bound_ms": bound, "bound_by": by, "max_abs_err": 0.0,
           "shape": f"Q={q_n} L={n_items} m={m}"}
    torch.cuda.synchronize()
    return out


def phase_support_timings(dev, eng, err, launches):
    """Phase 12 (kernel 7): both routes vs plain vs torch.sparse.mm at one
    6040-user chunk of the approx-recommend path."""
    from repro_torch.kernels.support import (fused_support_scores,
                                             support_scores_int8_plain)
    (dev_t, msk_t), r8, safe, w, means = chunk_operands(eng)
    b, k = safe.shape
    u, width = dev_t.shape
    n_items = r8.shape[1]
    args8 = (r8, means, safe, w, means)
    args_t = (dev_t, msk_t, safe, w, means)
    want = support_scores_int8_plain(*args8)
    e = max(max_diff(fused_support_scores(*args8), want),
            max_diff(fused_support_scores(*args_t), want))
    check(e == 0.0, f"support at timing shape diff {e}")
    ms = time_ms(lambda: fused_support_scores(*args8), reps=20)
    table_ms = time_ms(lambda: fused_support_scores(*args_t), reps=20)
    plain_ms = time_ms(lambda: support_scores_int8_plain(*args8), reps=3)
    # the library yardstick: the (b, U) CSR weight matrix against the
    # stacked (U, 2I') [dev | msk] table — the same SpMM, no epilogue
    crow = torch.arange(0, b * k + 1, k, dtype=torch.int64, device=dev)
    wmat = torch.sparse_csr_tensor(crow, safe.reshape(-1).long(),
                                   w.reshape(-1), size=(b, u))
    stacked = torch.cat([dev_t, msk_t], dim=1).contiguous()
    lib_ms = time_ms(lambda: torch.sparse.mm(wmat, stacked), reps=10)
    del stacked
    rows_read = int(torch.unique(safe).numel())
    common = b * k * 8.0 + b * 4.0 + b * width * 4.0
    # 4 operations (w·d, w·m and their adds) a term the data needs, 5 an
    # output for the epilogue
    terms = rated_terms(r8, safe, w)
    n_ops = 4.0 * terms + 5.0 * b * width
    bound, by = bound_ms(rows_read * (n_items + 4.0) + common, n_ops)
    table_bound = bound_ms(2.0 * rows_read * width * 4 + common, n_ops)[0]
    torch.cuda.synchronize()
    return [{"name": "fused_support_scores", "route": "cuda",
             "source": "src/repro_torch/csrc/support.cu",
             "replaces": "src/repro/kernels/support.py:68",
             "launches": launches["support"], "max_abs_err": max(err, e),
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
             "bound_by": by, "library_ms": lib_ms, "table_ms": table_ms,
             "table_bound_ms": table_bound,
             "nofma_floor_ms": 4.0 * terms / (PEAK_F32_OPS_PER_S / 2)
             * 1e3,
             "shape": f"b={b} k={k} U={u} I={n_items} I'={width} "
                      f"({rows_read} distinct neighbor rows, {terms} rated "
                      f"terms of {b * k * n_items}), int8 route"}]


def phase_timings(dev, eng, err, launches):
    """Phase 12 (exact kernels): kernel vs plain vs library at the exact
    main path's shapes."""
    from repro_torch.core import predict as pr
    from repro_torch.kernels.predict import (fused_tile_predict,
                                             tile_predict_plain)
    from repro_torch.kernels.similarity import (fused_similarity,
                                                similarity_plain)
    ratings, scores, idx, means = eng.snapshot()
    u, d = ratings.shape
    # one launch of the fit as it runs: the int8 operand, its max_value
    src = pr.make_gather_source(ratings)
    check(src.dtype == torch.int8, "the fit's similarity operand is int8")
    bound8 = int(src.max())
    block8 = src[:1024]
    block = ratings[:1024].contiguous()
    n = block.shape[0]
    want = similarity_plain(ratings, block, measure="pcc")
    e = max(max_diff(fused_similarity(src, block8, measure="pcc",
                                      max_value=bound8), want),
            max_diff(fused_similarity(ratings, block, measure="pcc"), want))
    check(e == 0.0, f"similarity at timing shape diff {e}")
    n_bad = torch.zeros(1, dtype=torch.int32, device=dev)
    sim_ms = time_ms(lambda: fused_similarity(src, block8, measure="pcc",
                                              max_value=bound8, n_bad=n_bad),
                     reps=20)
    check(int(n_bad.item()) == 0, "the timed launches' max_value holds")
    simt_ms = time_ms(lambda: fused_similarity(ratings, block,
                                               measure="pcc"))
    sim_plain = time_ms(lambda: similarity_plain(ratings, block,
                                                 measure="pcc"))
    ma, mb = (ratings > 0).float(), (block > 0).float()
    ops = [(ma, mb.T), (ratings, block.T), (ratings, mb.T), (ma, block.T),
           (ratings * ratings, mb.T), (ma, (block * block).T)]
    ops = [(a.contiguous(), b.contiguous()) for a, b in ops]
    sim_lib = time_ms(lambda: [torch.matmul(a, b) for a, b in ops])
    # the same six integer sums as torch._int_mm (squares ≤ 25 fit int8)
    m8a, m8b = (src > 0).to(torch.int8), (block8 > 0).to(torch.int8)
    planes = [(m8a, m8b), (src, block8), (src, m8b), (m8a, block8),
              (src * src, m8b), (m8a, block8 * block8)]
    int_mm = time_ms(lambda: [torch._int_mm(a, b.T) for a, b in planes])
    n_ops = 12.0 * u * n * d
    sim_bound, sim_by = bound_ms(u * d + n * d + u * n * 4.0, n_ops,
                                 PEAK_INT8_OPS_PER_S)
    f32_bound = bound_ms((u * d + n * d + u * n) * 4.0, n_ops)[0]

    # the recommend's launch: one 1024-user block × k=40 neighbors over
    # every item, int8 (and one 512-item tile, the previous design's)
    m = min(1024, u)
    src = pr.make_gather_source(ratings)
    ids = torch.where(idx[:m] >= 0, idx[:m], 0).to(torch.int32).contiguous()
    w = torch.where((scores[:m] > 0) & (idx[:m] >= 0), scores[:m],
                    torch.zeros_like(scores[:m])).contiguous()
    nbm = means[ids.long()].contiguous()
    qm = means[:m].contiguous()
    k = ids.shape[1]
    pred = {}
    for hi in (d, 512):
        def call(hi=hi):
            return fused_tile_predict(src, ids, w, nbm, qm, 0, hi)

        check(torch.equal(call().view(torch.int32), tile_predict_plain(
            src, ids, w, nbm, qm, 0, hi).view(torch.int32)),
            f"tile predict at timing shape [0, {hi}) bit for bit")
        pred[hi] = (time_ms_queued(call), time_ms(call, reps=50))
    (pred_ms, pred_call_ms), (tile_ms, tile_call_ms) = pred[d], pred[512]
    pred_plain = time_ms(lambda: tile_predict_plain(src, ids, w, nbm, qm, 0,
                                                    d), reps=3)
    # the library yardstick: the (m, U) CSR weight matrix against the
    # stacked (U, 2I) [dev | mask] rows — the same num / den, no epilogue
    crow = torch.arange(0, m * k + 1, k, dtype=torch.int64, device=dev)
    wmat = torch.sparse_csr_tensor(crow, ids.reshape(-1).long(),
                                   w.reshape(-1), size=(m, u))
    stacked = torch.cat([torch.where(ratings > 0, ratings - means[:, None],
                                     0.0), (ratings > 0).float()],
                        dim=1).contiguous()
    pred_lib = time_ms_queued(lambda: torch.sparse.mm(wmat, stacked),
                              reps=20)
    del stacked
    rows_read = int(torch.unique(ids).numel())
    pred_bytes = rows_read * d * 1 + m * k * 4 * 3 + m * 4 + m * d * 4
    # 4 operations a term the data needs, 5 an output for the epilogue
    pred_terms = rated_terms(src, ids, w)
    pred_bound, pred_by = bound_ms(pred_bytes,
                                   4.0 * pred_terms + 5.0 * m * d)
    torch.cuda.synchronize()
    return [
        {"name": "fused_similarity", "route": "cuda",
         "source": "src/repro_torch/csrc/similarity.cu",
         "replaces": "src/repro/kernels/similarity.py:110",
         "launches": launches["similarity"],
         "max_abs_err": max(err["similarity"], e), "ms": sim_ms,
         "plain_ms": sim_plain, "bound_ms": sim_bound, "bound_by": sim_by,
         "library_ms": sim_lib, "int_mm_ms": int_mm, "simt_ms": simt_ms,
         "f32_bound_ms": f32_bound,
         "shape": f"({u},{d})x({n},{d}) pcc int8 x int8, max_value "
                  f"{bound8}"},
        {"name": "fused_tile_predict", "route": "cuda",
         "source": "src/repro_torch/csrc/predict.cu",
         "replaces": "src/repro/kernels/predict.py:55",
         "launches": launches["predict"], "max_abs_err": err["predict"],
         "ms": pred_ms, "plain_ms": pred_plain, "bound_ms": pred_bound,
         "bound_by": pred_by, "library_ms": pred_lib,
         "call_ms": pred_call_ms, "tile_ms": tile_ms,
         "tile_call_ms": tile_call_ms,
         "nofma_floor_ms": 4.0 * pred_terms / (PEAK_F32_OPS_PER_S / 2)
         * 1e3,
         "shape": f"m={m} k={k} items[0,{d}) int8 src {u}x{d}, "
                  f"{rows_read} distinct neighbor rows, {pred_terms} rated "
                  f"terms of {m * k * d}"},
    ]


def phase_index_timings(dev, eng, err, launches):
    """Phase 12 (index kernels): kernel vs plain vs library at the approx
    path's shapes — one 2048-query block at 6040 users for the scan and
    the rerank, the cluster query's first 256-query block for the
    select."""
    from repro_torch.index import clustered as tcl
    from repro_torch.kernels.cluster import (centroid_distances_plain,
                                             fused_centroid_distances)
    from repro_torch.kernels.ref import proxy_scores_ref
    from repro_torch.kernels.rerank import (fused_rerank_scores,
                                            rerank_scores_plain)
    from repro_torch.kernels.select import (fused_scan_topm,
                                            proxy_scores_cuda,
                                            scan_topm_plain, select_topm,
                                            select_topm_twin)
    ix = eng.index
    ratings = eng.ratings
    n, d_items = ratings.shape
    rows = []

    def row(name, source, replaces, key, ms, plain_ms, lib_ms, e, n_bytes,
            n_ops, shape):
        bound, by = bound_ms(n_bytes, n_ops)
        err[key] = max(err[key], e)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[key],
                     "max_abs_err": err[key], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "library_ms": lib_ms, "shape": shape})

    # kernel 3: every proxy row against the centroids (spill / refold)
    x, c = ix.proxies, ix.centroids
    m, p = x.shape
    nc = c.shape[0]
    e = max_diff(fused_centroid_distances(x, c),
                 centroid_distances_plain(x, c))
    check(e == 0.0, f"centroid distances at timing shape diff {e}")
    row("fused_centroid_distances", "src/repro_torch/csrc/cluster.cu",
        "src/repro/kernels/cluster.py:73", "cluster",
        time_ms_queued(lambda: fused_centroid_distances(x, c)),
        time_ms(lambda: centroid_distances_plain(x, c), reps=5),
        time_ms_queued(lambda: torch.cdist(x, c).square()), e,
        ((m + nc) * p + m * nc) * 4.0,
        2.0 * m * nc * p + 2.0 * (m + nc) * p + 3.0 * m * nc,
        f"({m},{p})x({nc},{p})")
    rows[-1].update(
        call_ms=time_ms(lambda: fused_centroid_distances(x, c), reps=50),
        nofma_floor_ms=2.0 * m * nc * p / (PEAK_F32_OPS_PER_S / 2) * 1e3)

    # kernel 4: one 2048-query block of the full-pool scan; its two
    # launches (scores, radix select) also alone
    q_n = min(2048, n)
    mm = min(ix._max_rerank(eng.k), n)
    q = x[:q_n].contiguous()
    q_ids = torch.arange(q_n, dtype=torch.int32, device=dev)
    got = fused_scan_topm(q, x, q_ids, m=mm)
    want = scan_topm_plain(q, x, q_ids, mm)
    check(torch.equal(got[1], want[1]), "scan ids at timing shape")
    check(torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)),
          "scan values at timing shape bit for bit")
    e = max_diff(got[0], want[0])
    scores = proxy_scores_cuda(q, x)
    check(torch.equal(scores.view(torch.int32),
                      proxy_scores_ref(q, x).view(torch.int32)),
          "scan's score launch bit for bit")
    split = {"scores_ms": time_ms(lambda: proxy_scores_cuda(q, x), reps=20),
             "select_ms": time_ms(lambda: select_topm(scores, q_ids, m=mm),
                                  reps=20),
             "floor_ms": 2.0 * q_n * n * p / (132 * 128 * 1.98e9) * 1e3}
    row("fused_scan_topm", "src/repro_torch/csrc/select.cu",
        "src/repro/kernels/select.py:120", "scan",
        time_ms(lambda: fused_scan_topm(q, x, q_ids, m=mm), reps=20),
        time_ms(lambda: scan_topm_plain(q, x, q_ids, mm), reps=3),
        time_ms(lambda: torch.topk(torch.matmul(q, x.T), mm)), e,
        (q_n + n) * p * 4.0 + q_n * 4.0 + q_n * mm * 8.0,
        2.0 * q_n * n * p, f"Q={q_n} N={n} P={p} m={mm}")
    rows[-1]["split"] = split
    shorts = got[1]

    # kernel 5: the cluster-restricted select of the cluster query's first
    # block (n_probe 4, 256 queries)
    ids = torch.arange(256, device=dev)
    probe = tcl._probe_clusters(x, c, ids, n_probe=4,
                                use_kernel=True).cpu().numpy()
    cand = np.sort(ix._cluster_candidates(np.unique(probe)))
    cand_pad = np.full((tcl._bucket(len(cand)),), n, np.int64)
    cand_pad[:len(cand)] = cand
    cand_pad = torch.from_numpy(cand_pad).to(dev)
    sp = proxy_scores_ref(x[ids], x[cand_pad.clamp_max(n - 1)])
    sp = sp.masked_fill((cand_pad[None, :] >= n)
                        | (cand_pad[None, :] == ids[:, None]),
                        float("-inf")).contiguous()
    none = torch.full((256,), -1, dtype=torch.int32, device=dev)
    ms = min(mm, sp.shape[1])
    got5 = select_topm(sp, none, m=ms)
    want5 = select_topm_twin(sp, none, m=ms)
    check(torch.equal(got5[1], want5[1]), "select ids at timing shape")
    e = max_diff(got5[0], want5[0])
    big_l = sp.shape[1]
    row("select_topm", "src/repro_torch/csrc/select.cu",
        "src/repro/kernels/select.py:164", "select",
        time_ms_queued(lambda: select_topm(sp, none, m=ms)),
        time_ms(lambda: select_topm_twin(sp, none, m=ms), reps=5),
        time_ms_queued(lambda: torch.topk(sp, ms)), e,
        256 * big_l * 4.0 + 256 * 4.0 + 256 * ms * 8.0, 256.0 * big_l,
        f"Q=256 L={big_l} ({len(cand)} candidates) m={ms}")
    rows[-1]["call_ms"] = time_ms(lambda: select_topm(sp, none, m=ms),
                                  reps=20)

    # kernel 6: the union-Gram rerank of the same 2048-query block, pcc, as
    # the path calls it: int8 query rows and the real union columns (the
    # sentinel included) on the "imma" route
    u = torch.unique(shorts.long())
    u_real = int((u < n).sum())
    u = u.clamp_max(n - 1)
    kc = u.numel()
    src, bound = ix._gather_cache.get(ratings)
    norms, counts = tcl._user_norms_counts(ratings)
    qr = src[:q_n].contiguous()
    cr = src[u].contiguous()
    cn, cc = norms[u].contiguous(), counts[u].contiguous()
    check(qr.dtype == torch.int8 and cr.dtype == torch.int8,
          "the path's rerank operands are int8")

    def rerank():
        return fused_rerank_scores(qr, cr, cn, cc, measure="pcc",
                                   max_value=bound)

    before = fused_rerank_scores.routes["imma"]
    got6 = rerank()
    check(fused_rerank_scores.routes["imma"] == before + 1,
          "the timing shape takes the int8 route")
    want6 = rerank_scores_plain(qr, cr, cn, cc, measure="pcc")
    check(torch.equal(got6.view(torch.int32), want6.view(torch.int32)),
          "rerank at timing shape bit for bit")
    e = max_diff(got6, want6)
    # library yardsticks: six f32 matmuls; six torch._int_mm on the real
    # columns (the same integer sums; it needs widths a multiple of 8)
    qf, crf = qr.float(), cr.float()
    mq, mc = (qf > 0).float(), (crf > 0).float()
    ops = [(mq, mc.T), (qf, crf.T), (qf, mc.T), (mq, crf.T),
           (qf * qf, mc.T), (mq, (crf * crf).T)]
    ops = [(a.contiguous(), b.contiguous()) for a, b in ops]
    lib6 = time_ms(lambda: [torch.matmul(a, b) for a, b in ops], reps=5)
    kr = cr[:u_real - u_real % 8]
    planes = [((qr > 0).to(torch.int8), (kr > 0).to(torch.int8)),
              (qr, kr), (qr, (kr > 0).to(torch.int8)),
              ((qr > 0).to(torch.int8), kr), (qr * qr, (kr > 0).to(torch.int8)),
              ((qr > 0).to(torch.int8), kr * kr)]
    if bound > 11:                  # v² leaves int8
        int_mm = f"null (ratings up to {bound}: squares leave int8)"
    else:
        try:
            int_mm = time_ms(lambda: [torch._int_mm(a, b.T)
                                      for a, b in planes], reps=5)
        except (RuntimeError, AttributeError) as exc:   # a yardstick only
            int_mm = f"null ({type(exc).__name__}: {str(exc)[:80]})"
    simt_q = qr.float()
    check(torch.equal(fused_rerank_scores(simt_q, cr, cn, cc,
                                          measure="pcc").view(torch.int32),
                      want6.view(torch.int32)),
          "the simt route at the timing shape bit for bit")
    simt_ms = time_ms(lambda: fused_rerank_scores(simt_q, cr, cn, cc,
                                                  measure="pcc"), reps=3)
    ops6 = 6 * 2.0 * q_n * kc * d_items
    bytes6 = (q_n + kc) * d_items * 1.0 + kc * 8.0 + q_n * kc * 4.0
    bound6, by6 = bound_ms(bytes6, ops6, PEAK_INT8_OPS_PER_S)
    err["rerank"] = max(err["rerank"], e)
    rows.append({
        "name": "fused_rerank_scores", "route": "cuda",
        "source": "src/repro_torch/csrc/rerank.cu",
        "replaces": "src/repro/kernels/rerank.py:134",
        "launches": launches["rerank"], "max_abs_err": err["rerank"],
        "ms": time_ms(rerank, reps=10),
        "plain_ms": time_ms(lambda: rerank_scores_plain(
            qr, cr, cn, cc, measure="pcc"), reps=5),
        "bound_ms": bound6, "bound_by": by6, "library_ms": lib6,
        "shape": f"G={q_n} Kc={kc} ({u_real} distinct candidates"
                 f"{' + the sentinel' if kc > u_real else ''}) J={d_items} "
                 f"pcc int8 x int8, max_value {bound}",
        "int_mm_ms": int_mm, "simt_ms": simt_ms,
        "simt_bound_ms": bound_ms(
            (q_n * 4.0 + kc) * d_items + kc * 8.0 + q_n * kc * 4.0, ops6)[0]})
    torch.cuda.synchronize()
    return rows


def flash_close(name, got, q, k, v, **kw):
    """The flash kernel's output against its plain version on the same
    inputs: f32 within 1e-5; bf16 against the plain f32 result rounded to
    bf16, within 2e-2 and, elementwise, within one bf16 unit in the last
    place (≤ |x|·2⁻⁷) plus 1e-5: the kernel accumulates in f32 too, so the
    two f32 results round to the same or to adjacent bf16 values.  Returns
    the max abs diff."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    want = flash_attention_plain(q.float(), k.float(), v.float(),
                                 **kw).to(q.dtype)
    e = max_diff(got, want)
    check(got.dtype == q.dtype, f"{name} output dtype")
    check(e <= FLASH_TOL[q.dtype], f"{name} diff {e}")
    if q.dtype == torch.bfloat16 and got.numel():
        g, w = got.float(), want.float()
        over = (g - w).abs() - (BF16_ULP * torch.maximum(g.abs(), w.abs())
                                + 1e-5)
        over = float(torch.where(g == w, torch.zeros_like(g), over).max())
        check(over <= 0, f"{name}: {over} past one bf16 ulp + 1e-5")
    return e


def phase_flash_kernel(dev):
    """Phase 10: the flash-attention kernel against its plain version on
    the card — Sq ≠ Skv, ragged tails, groups 1/4/8, d = 64 / 128 / 192
    (dv 128), causal and not, decode with a ragged per-row kv_len (keys
    past it hold NaN), fully masked rows (Sq > Skv), f32 and bf16."""
    from repro_torch.kernels.flash_attention import flash_attention
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [(2, 2, 1, 77, 77, 64, 64), (1, 2, 4, 50, 130, 128, 128),
              (2, 1, 8, 33, 200, 64, 64), (1, 2, 4, 40, 100, 192, 128),
              (1, 1, 2, 20, 8, 64, 64)]
    for dtype in (torch.float32, torch.bfloat16):
        for b, hkv, g, sq, skv, d, dv in shapes:
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for shape in ((b, hkv * g, sq, d), (b, hkv, skv, d),
                                     (b, hkv, skv, dv)))
            for causal in (True, False):
                name = (f"flash {str(dtype)[6:]} b={b} hkv={hkv} g={g} "
                        f"sq={sq} skv={skv} d={d} dv={dv} causal={causal}")
                got = flash_attention(q, k, v, causal=causal)
                e = flash_close(name, got, q, k, v, causal=causal)
                err[dtype] = max(err[dtype], e)
                if causal and sq > skv:
                    check(bool((got[:, :, :sq - skv] == 0).all()),
                          f"{name}: fully masked rows are 0")
        b, hkv, g, skv, d = 4, 8, 4, 300, 64
        for sq, lens in ((1, [1, 77, 300, 150]), (5, [5, 64, 200, 9])):
            q = torch.randn((b, hkv * g, sq, d), generator=gen,
                            device=dev).to(dtype)
            k, v = (torch.randn((b, hkv, skv, d), generator=gen,
                                device=dev).to(dtype) for _ in range(2))
            kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
            for row, n in enumerate(lens):
                k[row, :, n:] = float("nan")
                v[row, :, n:] = float("nan")
            got = flash_attention(q, k, v, causal=True, kv_len=kv_len)
            check(bool(torch.isfinite(got).all()),
                  f"flash kv_len {lens}: no key past kv_len is read")
            e = flash_close(f"flash kv_len sq={sq}", got, q, k, v,
                            causal=True, kv_len=kv_len)
            err[dtype] = max(err[dtype], e)
        log(f"  {str(dtype)[6:]}: {len(shapes) * 2 + 2} cases, "
            f"max_abs_diff={err[dtype]!r} (tolerance {FLASH_TOL[dtype]})")
    seen = phase_flash_routes(dev, gen, err)
    log(f"  bf16 by route: {seen} calls, each on its expected route; "
        f"max_abs_diff={err[torch.bfloat16]!r}")
    torch.cuda.synchronize()
    return err


def phase_flash_routes(dev, gen, err):
    """Phase 10, the bf16 routes by name (each call's route counter is
    checked): Sq·group 16 / 17 at the split / tensor-core boundary;
    per-row kv_len of 0, 1, < one split (128 keys), one split, past one
    split and every split on both routes (NaN past kv_len, exact zeros at
    0); d / dv of 40, 72 and 256; rows 65 elements apart."""
    from repro_torch.kernels.flash_attention import flash_attention
    routes = flash_attention.routes
    seen = dict.fromkeys(routes, 0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def routed(name, want, q, k, v, **kw):
        before = dict(routes)
        got = flash_attention(q, k, v, **kw)
        check(routes[want] == before[want] + 1
              and sum(routes.values()) == sum(before.values()) + 1,
              f"{name}: one launch on the {want} route")
        seen[want] += 1
        err[torch.bfloat16] = max(err[torch.bfloat16],
                                  flash_close(name, got, q, k, v, **kw))
        return got

    for hkv, grp, sq, want in ((2, 8, 2, "split"), (1, 1, 16, "split"),
                               (1, 1, 17, "mma"), (2, 17, 1, "mma")):
        q, k, v = rnd(2, hkv * grp, sq, 64), rnd(2, hkv, 200, 64), \
            rnd(2, hkv, 200, 64)
        for causal in (True, False):
            routed(f"flash bf16 hkv={hkv} g={grp} sq={sq} causal={causal}",
                   want, q, k, v, causal=causal)
    lens = [0, 1, 100, 128, 257, 384]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    for sq, want in ((1, "split"), (5, "mma")):
        q, k, v = rnd(6, 8, sq, 64), rnd(6, 2, 384, 64), rnd(6, 2, 384, 64)
        for row, n in enumerate(lens):
            k[row, :, n:] = float("nan")
            v[row, :, n:] = float("nan")
        got = routed(f"flash bf16 kv_len {lens} sq={sq}", want, q, k, v,
                     causal=True, kv_len=kv_len)
        check(bool(torch.isfinite(got).all()),
              f"flash bf16 kv_len sq={sq}: no key past kv_len is read")
        check(bool((got[0] == 0).all()),
              f"flash bf16 kv_len sq={sq}: kv_len 0 gives exact zeros")
    for d, dv in ((40, 72), (72, 40), (256, 256), (256, 40), (72, 256)):
        for sq, want in ((1, "split"), (33, "mma")):
            q, k, v = rnd(2, 8, sq, d), rnd(2, 2, 150, d), rnd(2, 2, 150, dv)
            routed(f"flash bf16 d={d} dv={dv} sq={sq}", want, q, k, v,
                   causal=True)
    kv_len = torch.tensor([90, 37], dtype=torch.int32, device=dev)
    for sq, want in ((1, "split"), (40, "mma")):
        q, k, v = (rnd(2, h, n, 65)[..., :64]
                   for h, n in ((8, sq), (2, 90), (2, 90)))
        routed(f"flash bf16 rows 65 apart sq={sq}", want, q, k, v,
               causal=True, kv_len=kv_len)
    check(seen["split"] > 0 and seen["mma"] > 0, "both bf16 routes ran")
    return seen


def lm_margin_agree(kern, plain, margin=0.05):
    """argmax agreement on every row whose plain top-2 margin exceeds
    ``margin``; returns (rows checked, rows agreeing)."""
    top = plain.max(-1)
    rest = plain.scatter(-1, top.indices[:, None], float("-inf")).max(-1)
    rows = (top.values - rest.values) > margin
    same = kern.argmax(-1) == top.indices
    return int(rows.sum()), int((same & rows).sum())


def phase_lm(dev):
    """Phase 11: Llama-3.2-1B at full width (16 layers, d 2048, 32/8
    heads, vocab 128256, bf16), weights from a seeded generator on the
    card: ``build_step`` prefill on 4 prompts × 2048 tokens (``lm_batch``
    seed 0, max_len 2080) and 16 greedy decode steps, with the flash
    kernel's launch count zeroed before and read after; then the same
    model with the attention on the plain version, teacher-forced on the
    same tokens, logits compared at every step."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.batches import lm_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.steps import build_step
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tx

    arch = get_arch("llama3_2_1b")
    cfg = arch.config
    b, s, max_len, steps = 4, 2048, 2080, 16
    prefill = build_step(arch, dataclasses.replace(
        arch.cell("prefill_32k"), name="prefill_2k",
        dims={"batch": b, "seq": s}))
    decode = build_step(arch, dataclasses.replace(
        arch.cell("decode_32k"), name="decode_2k",
        dims={"batch": b, "seq": max_len}))
    out = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = tx.Transformer(cfg, tx.init_params(cfg, gen))
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params"] = cm.count_params(model)
    check(out["params"] == cfg.param_count(), "parameter count")
    toks = torch.from_numpy(lm_batch(b, s, cfg.vocab, seed=0)["tokens"]
                            ).to(dev)
    # warm-up on a short prompt (library handles, kernel load); not counted
    warm, wc = prefill.fn(model, {"tokens": toks[:, :64]}, max_len=80)
    decode.fn(model, {"tokens": warm.argmax(-1, keepdim=True).int(),
                      "cache": wc})
    torch.cuda.synchronize()

    for fn in all_wrappers().values():
        fn.launches = 0
    routes = flash_attention.routes
    routes.update(dict.fromkeys(routes, 0))
    t0 = time.perf_counter()
    logits, cache = prefill.fn(model, {"tokens": toks}, max_len=max_len)
    torch.cuda.synchronize()
    out["prefill_s"] = time.perf_counter() - t0
    pre_launches = flash_attention.launches
    pre_routes = dict(routes)
    kern_logits = [logits.clone()]
    fed = []
    t0 = time.perf_counter()
    for _ in range(steps):
        nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
        fed.append(nxt)
        logits, cache = decode.fn(model, {"tokens": nxt, "cache": cache})
        kern_logits.append(logits.clone())
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    out["launches"] = {"prefill": pre_launches,
                       "decode": flash_attention.launches - pre_launches}
    check(out["launches"]["prefill"] > 0, "flash kernel launched in prefill")
    check(out["launches"]["decode"] > 0, "flash kernel launched in decode")
    out["routes"] = {"prefill": pre_routes,
                     "decode": {k: routes[k] - pre_routes[k] for k in routes}}
    check(pre_routes["mma"] == pre_launches,
          f"every prefill launch on the tensor-core route: {pre_routes}")
    check(out["routes"]["decode"]["split"] == out["launches"]["decode"],
          f"every decode launch on the split-K route: {out['routes']}")
    out["decode_ms_per_token"] = decode_s / steps * 1e3
    out["tokens_per_s"] = b * steps / decode_s
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    check(cache["len"].tolist() == [s + steps] * b,
          f"cache len {cache['len'].tolist()} == {s + steps}")
    for lg in kern_logits:
        check(tuple(lg.shape) == (b, cfg.vocab) and
              bool(torch.isfinite(lg).all()), "finite logits (B, V)")

    # the layer-0 q / k / v of this prefill, kernel vs plain
    with torch.inference_mode():
        p0 = model._layers[0]
        h = cm.rmsnorm(p0["ln1"], model._embed[toks.long()])
        pos = torch.arange(s, device=dev)[None].expand(b, s)
        q, k, v = tx._gqa_qkv(cfg, p0["attn"], h, pos)
        out["layer0_err"] = flash_close(
            "flash at layer 0 of the prefill", flash_attention(q, k, v), q,
            k, v, causal=True)
        qf, kf, vf = (t.float() for t in (q, k, v))
        out["layer0_err_f32"] = flash_close(
            "flash at layer 0 of the prefill, f32 copies",
            flash_attention(qf, kf, vf), qf, kf, vf, causal=True)
        del qf, kf, vf
    out["qkv"] = (q, k, v)
    out["cache"] = cache

    model.use_kernel = False
    with torch.inference_mode():
        plain, pc = prefill.fn(model, {"tokens": toks}, max_len=max_len)
        diffs, checked, agree = [], 0, 0
        for step in range(steps + 1):
            if step:
                plain, pc = decode.fn(model, {"tokens": fed[step - 1],
                                              "cache": pc})
            diffs.append(max_diff(kern_logits[step], plain))
            n, a = lm_margin_agree(kern_logits[step], plain)
            checked, agree = checked + n, agree + a
    model.use_kernel = True
    out["max_logit_diff"] = max(diffs)
    out["logit_diffs"] = diffs
    out["argmax"] = (agree, checked)
    check(agree == checked, f"argmax agrees on rows with margin > 0.05: "
                            f"{agree} of {checked}")
    check(checked > 0, "some rows have a top-2 margin above 0.05")
    check(pc["len"].tolist() == [s + steps] * b, "plain cache len")
    out["model"], out["toks"], out["plain_cache"] = model, toks, pc
    out["steps"] = (prefill, decode)
    torch.cuda.synchronize()
    return out


def phase_flash_timings(lm, err):
    """Phase 12 (flash attention): the prefill launch (4 × 32 × 2048 × 64,
    causal, bf16: the layer-0 q / k / v of phase 11) and a decode launch
    (Sq = 1 against phase 11's layer-0 cache at kv_len 2049).  Library
    yardstick: ``scaled_dot_product_attention`` (never called by the
    port)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    def lib_ms(q, k, v, causal, timer=time_ms):
        """One ``scaled_dot_product_attention`` call, K/V repeated before
        the timed call where this PyTorch has no ``enable_gqa``."""
        if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
            return timer(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True))
        g = q.shape[1] // k.shape[1]
        kr, vr = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
        return timer(lambda: F.scaled_dot_product_attention(
            q, kr, vr, is_causal=causal))

    q, k, v = lm["qkv"]
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    with torch.inference_mode():
        ms = time_ms(lambda: flash_attention(q, k, v), reps=10)
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v), reps=3)
        library = lib_ms(q, k, v, True)
        pairs = s * (s + 1) / 2
        n_bytes = (2 * b * hq * s * d + 2 * b * hkv * s * d) * 2.0
        bound, by = bound_ms(n_bytes, 4.0 * b * hq * pairs * d,
                             PEAK_BF16_OPS_PER_S)

        kv_n = s + 1
        qd = q[:, :, -1:].contiguous()
        kc, vc = lm["cache"]["k"][0], lm["cache"]["v"][0]
        kv_len = torch.full((b,), kv_n, dtype=torch.int32, device=q.device)
        got = flash_attention(qd, kc, vc, kv_len=kv_len)
        d_err = flash_close("flash decode launch", got, qd, kc, vc,
                            causal=True, kv_len=kv_len)
        qf, kf, vf = (t.float() for t in (qd, kc, vc))
        d_err_f32 = flash_close(
            "flash decode launch, f32 copies",
            flash_attention(qf, kf, vf, kv_len=kv_len), qf, kf, vf,
            causal=True, kv_len=kv_len)
        del qf, kf, vf
        dec = {"ms": time_ms_queued(lambda: flash_attention(
                   qd, kc, vc, kv_len=kv_len)),
               "call_ms": time_ms(lambda: flash_attention(
                   qd, kc, vc, kv_len=kv_len), reps=50),
               "plain_ms": time_ms(lambda: flash_attention_plain(
                   qd, kc, vc, kv_len=kv_len), reps=10),
               "library_ms": lib_ms(qd, kc[:, :, :kv_n].contiguous(),
                                    vc[:, :, :kv_n].contiguous(), False,
                                    time_ms_queued),
               "max_abs_err": d_err, "max_abs_err_f32": d_err_f32}
        dec["bound_ms"], dec["bound_by"] = bound_ms(
            (2 * b * hkv * kv_n * d + 2 * b * hq * d) * 2.0,
            4.0 * b * hq * kv_n * d, PEAK_BF16_OPS_PER_S)
    torch.cuda.synchronize()
    launches = lm["launches"]["prefill"] + lm["launches"]["decode"]
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:84",
           "launches": launches,
           "max_abs_err": max(lm["layer0_err"], err), "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
           "library_ms": library,
           "shape": f"prefill B={b} Hq={hq} Hkv={hkv} S={s} d={d} bf16 "
                    f"causal"}
    return row, dec


def phase_profile(eng, eng_approx, eng_rec, lm) -> None:
    """Phase 13: where the device time of a steady exact fit, of
    recommend(all users), of an approx query (all users; fused, then
    staged), of an approx
    recommend (all users), of the LM prefill (4 × 2048) and of one LM
    decode step (4 rows at ~2065 cached positions) goes (device-side
    events only: kernels and copies, so no operator's time is counted
    twice)."""
    approx_query = (lambda: eng_approx.index.query(
        eng_approx.ratings, eng_approx.means, k=eng_approx.k,
        measure=eng_approx.measure))

    def staged_query():
        eng_approx.index.query_mode_override = "staged"
        try:
            approx_query()
        finally:
            eng_approx.index.query_mode_override = None
    prefill, decode = lm["steps"]
    model, toks = lm["model"], lm["toks"]
    state = {"cache": lm["plain_cache"]}

    def lm_prefill():
        prefill.fn(model, {"tokens": toks}, max_len=toks.shape[1] + 32)

    def lm_decode():
        nxt = toks[:, -1:].contiguous()
        state["cache"] = decode.fn(model, {"tokens": nxt,
                                           "cache": state["cache"]})[1]

    profile_each((("fit", eng.fit),
                  ("recommend", lambda: eng.recommend(n=10)),
                  ("approx query", approx_query, 16),
                  ("approx query, staged", staged_query, 10),
                  ("approx recommend", lambda: eng_rec.recommend(n=10)),
                  ("LM prefill", lm_prefill),
                  ("LM decode step", lm_decode)))


def profile_each(named, n_rows: int = 6, warm: bool = True) -> list:
    """For each (name, fn[, rows]): one warm call (unless ``warm`` is
    false: the caller's calls were), then one call under
    ``torch.profiler``; logs wall ms, device-busy ms and share, and the
    ``rows`` (default ``n_rows``) largest device-time entries.  Returns
    each call's (wall ms, device-busy ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = []
    for name, fn, *rows_wanted in named:
        if warm:
            fn()
            torch.cuda.synchronize()
        # now and then a trace holds no device events although the call
        # launched kernels: profile the call again, up to three times,
        # before failing
        for attempt in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                           for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA),
                          reverse=True)
            busy_ms = sum(r[0] for r in rows)
            if busy_ms > 0:
                break
            log(f"    {name}: the profiler recorded no device events "
                f"(attempt {attempt + 1} of 3)")
        check(busy_ms > 0, f"profiler saw device work in {name}")
        log(f"    {name}: wall {wall_ms:.2f} ms, device busy "
            f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %)")
        for ms, n, key in rows[:rows_wanted[0] if rows_wanted else n_rows]:
            log(f"      {ms:9.3f} ms  x{n:<4d} {key[:72]}")
        out.append((wall_ms, busy_ms))
    return out


# -- the recsys CTR slice (DLRM-MLPerf, FM, xDeepFM) and kernel 9 -----------

DLRM_ROW_CAP = 20_000_000       # rows per DLRM field kept on one 80 GB card
DLRM_RET_N = 262_144            # DLRM retrieval candidates (cut from 2^20)
XDEEPFM_BULK_ROWS = 16_384      # xDeepFM serve_bulk rows (cut from 262144)
BAG_SHAPE = (2048, 100)         # multi-hot bags × L (MLPerf DLRM-DCNv2's
                                # largest Criteo multi-hot bag)
BAG_BIG_ROWS = 17_000_000       # × 128 bf16: a table of 2.18e9 elements


def bag_close(name, table, ids, combiner):
    """Kernel 9 through its wrapper against its plain version on the same
    inputs: bitwise (max abs diff 0.0).  Returns (kernel output, diff)."""
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_plain)
    got = embedding_bag(table, ids, combiner=combiner)
    want = embedding_bag_plain(table, ids, combiner=combiner)
    e = max_diff(got, want)
    check(got.dtype == table.dtype and got.shape == want.shape,
          f"{name} dtype / shape")
    check(e == 0.0, f"{name} diff {e} (0.0 required)")
    return got, e


def phase_bag_kernel(dev):
    """Phase 14: kernel 9 (embedding bag) against its plain version on the
    card — B = L = 1 at D = 1 / 10 / 128, all-padding bags (mean exactly
    0), −1 spread through the bags, f32 and bf16 tables, sum and mean,
    int32 and int64 ids, both routes ("warp", "slots") taken, one
    launch on a bf16 table of more than 2^31 elements (64-bit offsets);
    the check launch's and the bag launch's counts of ids past the table
    against the plain count, and the wrapper raising on them.  Returns (max diff, cases, launches
    by route)."""
    from repro_torch.kernels.embedding_bag import embedding_bag, launch
    gen = torch.Generator(device=dev).manual_seed(14)
    err, cases = 0.0, 0
    routes = dict(embedding_bag.routes)
    shapes = [(50, 1, 1, 1), (50, 10, 1, 1), (300, 128, 1, 1),
              (1000, 1, 37, 9), (1000, 10, 37, 9), (5000, 128, 513, 100),
              (777, 12, 5, 33), (64, 300, 7, 40)]
    for dtype in (torch.float32, torch.bfloat16):
        for v, d, b, l in shapes:
            table = torch.randn((v, d), generator=gen, device=dev).to(dtype)
            ids = torch.randint(0, v, (b, l), generator=gen, device=dev,
                                dtype=torch.int32)
            pad = torch.rand((b, l), generator=gen, device=dev) < 0.3
            ids = torch.where(pad, torch.full_like(ids, -1), ids)
            if b > 2:
                ids[2] = -1                             # all-padding bag
            for combiner in ("sum", "mean"):
                for id_t in (ids, ids.long()):
                    got, e = bag_close(
                        f"bag {str(dtype)[6:]} V={v} D={d} B={b} L={l} "
                        f"{combiner} {str(id_t.dtype)[6:]}", table, id_t,
                        combiner)
                    err, cases = max(err, e), cases + 1
                    if b > 2:
                        check(bool((got[2] == 0).all()),
                              "all-padding bag is exactly 0")
    routes = {k: v - routes[k] for k, v in embedding_bag.routes.items()}
    check(min(routes.values()) > 0, f"every bag route taken: {routes}")
    # the wrapper's check launch and the bag launch's own count of ids
    # past the table against the plain count, and the wrapper raising
    ids = torch.randint(-1, 1200, (300, 70), generator=gen, device=dev,
                        dtype=torch.int32)
    table = torch.randn((1000, 16), generator=gen, device=dev)
    n_bad = torch.zeros((1,), dtype=torch.int32, device=dev)
    for id_t in (ids, ids.long()):
        want = int((id_t >= 1000).sum())
        n_bad.zero_()
        launch(table, id_t, n_bad)
        check(int(n_bad.item()) == want > 0,
              "the launch counts the ids past the table as the plain "
              "count does")
        try:
            embedding_bag(table, id_t)
            check(False, "the wrapper raises on ids past the table")
        except ValueError as e:
            check(str(e).startswith(f"{want} id(s) "),
                  f"the check launch counts them as the plain count does: "
                  f"{e}")
    big_rows, d = BAG_BIG_ROWS, 128
    table = torch.empty((big_rows, d), dtype=torch.bfloat16, device=dev)
    table.normal_(generator=gen)
    past = min(2**31 // d, big_rows - 1)          # rows past 2^31 elements
    ids = torch.randint(past, big_rows, (256, 20), generator=gen,
                        device=dev, dtype=torch.int32)
    ids[:, 0] = big_rows - 1
    ids[:, 7] = -1
    for combiner in ("sum", "mean"):
        _, e = bag_close(f"bag bf16 table {big_rows}x{d} ({table.numel()} "
                         f"elements) {combiner}", table, ids, combiner)
        err, cases = max(err, e), cases + 1
    del table
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return err, cases, routes


def serve_latencies(step, model, batch, n, warm=3):
    """Host-clock ms of ``n`` calls of ``step`` (each ended by a device
    synchronize) after ``warm`` untimed ones; returns (ms array, output)."""
    for _ in range(warm):
        step.fn(model, batch)
    torch.cuda.synchronize()
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = step.fn(model, batch)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return np.array(lat), out


def recsys_inputs(cfg, batch, seed):
    """``recsys_batch`` without labels (host numpy: what a caller sends)."""
    from repro_torch.data.batches import recsys_batch
    out = recsys_batch(batch, cfg.field_sizes, getattr(cfg, "n_dense", 0),
                       seed=seed)
    out.pop("labels")
    return out


def substituted(ctx, cand, field):
    """The context broadcast to every candidate with ``field`` set."""
    out = {k: np.repeat(v, len(cand), axis=0) for k, v in ctx.items()}
    out["sparse"][:, field] = cand
    return out


def multi_hot_ids(layout, shape, seed):
    """(B, L) fused-table ids of the sharded fields: each slot a sharded
    field drawn uniformly and an id in it drawn as ``recsys_batch`` draws
    one (zipf(1.2) − 1 clipped to the field), about 10 % padding (−1)."""
    rng = np.random.default_rng(seed)
    fields = np.array(layout.sharded_fields)
    pick = fields[rng.integers(0, len(fields), shape)]
    sizes = np.array(layout.field_sizes)[pick]
    offs = np.array([layout._field_offset(int(f)) for f in fields])
    off = offs[np.searchsorted(fields, pick)]
    ids = np.minimum(rng.zipf(1.2, shape) - 1, sizes - 1) + off
    ids[rng.random(shape) < 0.1] = -1
    return ids.astype(np.int32)


def phase_dlrm(dev):
    """Phase 15: DLRM-MLPerf at its published widths (26 fields, embed 128,
    bottom 13-512-256-128, top 1024-1024-512-256-1), every field capped at
    ``DLRM_ROW_CAP`` rows, random weights from a seeded generator on the
    card: ``build_step`` serve_p99 (512 rows, ≥ 50 timed steps),
    serve_bulk (262,144 rows) and retrieval_cand cut to 262,144
    candidates; retrieval == forward on the substituted batch; the
    serve_p99 lookups of the sharded fields as L = 1 bags through
    ``ops.embedding_bag`` equal the step's gathered rows bit for bit; the
    multi-hot bags over the fused table through ``ops.embedding_bag``
    (== the plain version), with every launch count zeroed before the
    steps and kernel 9's read after the bags (> 0)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.batches import candidates
    from repro_torch.kernels import ops
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_plain)
    from repro_torch.launch.steps import build_step
    from repro_torch.models import common as cm
    from repro_torch.models import dlrm
    from repro_torch.models import embedding as emb

    arch = get_arch("dlrm_mlperf")
    full = arch.config
    cfg = dataclasses.replace(full, field_sizes=tuple(
        min(s, DLRM_ROW_CAP) for s in full.field_sizes))
    arch = dataclasses.replace(arch, config=cfg)
    out = {"reduced": [f"field {i}: {s} -> {DLRM_ROW_CAP} rows"
                       for i, s in enumerate(full.field_sizes)
                       if s > DLRM_ROW_CAP],
           "full_params": full.param_count()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = dlrm.DLRM(cfg, dlrm.init_params(cfg, gen))
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params"] = cm.count_params(model)
    out["rows"] = cfg.layout().sharded_rows + cfg.layout().replicated_rows
    check(out["params"] == cfg.param_count(), "DLRM parameter count")
    out["table_gib"] = out["params"] * 4 / 2**30

    serve = build_step(arch, arch.cell("serve_p99"))
    bulk_cell = arch.cell("serve_bulk")
    bulk = build_step(arch, bulk_cell)
    ret_n = DLRM_RET_N
    ret = build_step(arch, dataclasses.replace(
        arch.cell("retrieval_cand"), name="retrieval_262k",
        dims={"batch": 1, "n_candidates": ret_n}))
    b_p99 = recsys_inputs(cfg, serve.example_args["sparse"].shape[0], 0)
    b_bulk = recsys_inputs(cfg, bulk_cell.dims["batch"], 1)
    ctx = recsys_inputs(cfg, 1, 2)
    cand = candidates(ret_n, cfg.field_sizes[cfg.candidate_field], seed=3)

    zero_counts()
    lat, logits = serve_latencies(serve, model, b_p99, 60)
    out["p99_lat"] = lat
    check(tuple(logits.shape) == (len(b_p99["sparse"]),)
          and bool(torch.isfinite(logits).all()),
          "serve_p99 logits finite (B,)")
    lat, logits = serve_latencies(bulk, model, b_bulk, 5, warm=1)
    out["bulk_ms"], out["bulk_rows"] = lat, bulk_cell.dims["batch"]
    check(tuple(logits.shape) == (bulk_cell.dims["batch"],)
          and bool(torch.isfinite(logits).all()), "serve_bulk logits finite")
    lat, scores = serve_latencies(ret, model, {**ctx, "candidates": cand}, 3,
                                  warm=1)
    out["ret_ms"], out["ret_n"] = lat, ret_n
    check(tuple(scores.shape) == (ret_n,) and bool(torch.isfinite(scores).all()),
          "retrieval scores finite (N,)")
    out["ret_vs_fwd"] = max_diff(scores, model(substituted(
        ctx, cand, cfg.candidate_field)))
    check(out["ret_vs_fwd"] <= 1e-5,
          f"retrieval == forward on the substituted batch ({out['ret_vs_fwd']})")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30

    # kernel 9 on this path: L = 1 bags of the serve_p99 lookups, then the
    # multi-hot bags over the fused table
    layout = cfg.layout()
    tables = model.tree()["tables"]
    sparse = torch.from_numpy(b_p99["sparse"]).to(dev)
    sf = list(layout.sharded_fields)
    with torch.inference_mode():
        rows = emb.sharded_lookup(layout, tables, sparse)[:, sf]
        ids = layout.global_ids(sparse[:, sf], sf).reshape(-1, 1)
        bags = ops.embedding_bag(tables["sharded"], ids.contiguous())
    check(torch.equal(bags.reshape(rows.shape), rows),
          "L = 1 bags through ops.embedding_bag == the serve step's lookups")
    out["l1_bags"] = tuple(ids.shape)
    mh = torch.from_numpy(multi_hot_ids(layout, BAG_SHAPE, 4)).to(dev)
    out["bag_err"] = 0.0
    for combiner in ("sum", "mean"):
        with torch.inference_mode():
            got = ops.embedding_bag(tables["sharded"], mh, combiner=combiner)
            want = embedding_bag_plain(tables["sharded"], mh,
                                       combiner=combiner)
        e = max_diff(got, want)
        check(e == 0.0, f"multi-hot bags {BAG_SHAPE} {combiner}: kernel vs "
                        f"plain diff {e} (0.0 required)")
        out["bag_err"] = max(out["bag_err"], e)
    out["launches"] = embedding_bag.launches
    out["routes"] = dict(embedding_bag.routes)
    check(out["launches"] > 0, "embedding-bag kernel launched on the path")
    check(out["routes"]["warp"] == out["launches"],
          f"every DLRM bag launch on the one-bag-a-warp route: "
          f"{out['routes']}")
    out["model"], out["multi_hot"] = model, mh
    out["l1_ids"] = ids.contiguous()
    out["steps"] = (serve, bulk, b_p99, b_bulk)
    torch.cuda.synchronize()
    return out


def phase_fm_xdeepfm(dev):
    """Phase 17: FM and xDeepFM at their full published configs (Criteo-39
    vocabularies, 3.94 M rows; embed 10; xDeepFM CIN 200-200-200, DNN
    400-400), random weights from a seeded generator on the card:
    serve_p99 (≥ 50 timed steps), serve_bulk (FM 262,144 rows; xDeepFM
    cut to 16,384) and retrieval_cand (1,048,576 candidates; xDeepFM in
    128 chunks of 8192); FM's factorised retrieval == its forward on the
    substituted batch within 1e-5; phase 15's multi-hot bag shape over
    FM's factor (D = 10) and linear (D = 1) tables through
    ``ops.embedding_bag``, sum and mean, == the plain version bit for bit,
    with every launch count zeroed before the path and kernel 9's launch
    and route counts read after it (every launch on the slots route)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.batches import candidates
    from repro_torch.kernels import ops
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_plain)
    from repro_torch.launch.steps import build_step
    from repro_torch.models import common as cm
    from repro_torch.models import fm, xdeepfm

    zero_counts()
    res = {}
    for name, mod, cls in (("fm", fm, fm.FM),
                           ("xdeepfm", xdeepfm, xdeepfm.XDeepFM)):
        arch = get_arch(name)
        cfg = arch.config
        out = {"reduced": []}
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev).manual_seed(0)
        model = cls(cfg, mod.init_params(cfg, gen))
        out["params"] = cm.count_params(model)
        check(out["params"] == cfg.param_count(), f"{name} parameter count")
        serve = build_step(arch, arch.cell("serve_p99"))
        bulk_cell = arch.cell("serve_bulk")
        if name == "xdeepfm":
            rows = XDEEPFM_BULK_ROWS
            out["reduced"].append(
                f"serve_bulk {bulk_cell.dims['batch']} -> {rows} rows (the "
                f"CIN outer product at 262144 rows is 81.8 GB in f32)")
            bulk_cell = dataclasses.replace(bulk_cell, name="serve_16k",
                                            dims={"batch": rows})
        bulk = build_step(arch, bulk_cell)
        ret_cell = arch.cell("retrieval_cand")
        ret = build_step(arch, ret_cell)
        n = ret_cell.dims["n_candidates"]
        b_p99 = recsys_inputs(cfg, serve.example_args["sparse"].shape[0], 0)
        b_bulk = recsys_inputs(cfg, bulk_cell.dims["batch"], 1)
        ctx = recsys_inputs(cfg, 1, 2)
        cand = candidates(n, cfg.field_sizes[cfg.candidate_field], seed=3)
        lat, logits = serve_latencies(serve, model, b_p99, 60)
        out["p99_lat"] = lat
        check(bool(torch.isfinite(logits).all())
              and logits.shape == (len(b_p99["sparse"]),),
              f"{name} serve_p99 logits finite (B,)")
        lat, logits = serve_latencies(bulk, model, b_bulk, 5, warm=1)
        out["bulk_ms"], out["bulk_rows"] = lat, bulk_cell.dims["batch"]
        check(bool(torch.isfinite(logits).all()), f"{name} serve_bulk finite")
        lat, scores = serve_latencies(ret, model, {**ctx, "candidates": cand},
                                      3, warm=1)
        out["ret_ms"], out["ret_n"] = lat, n
        check(tuple(scores.shape) == (n,) and bool(torch.isfinite(scores)
                                                   .all()),
              f"{name} retrieval scores finite ({n},)")
        if name == "fm":
            out["ret_vs_fwd"] = max_diff(scores, model(substituted(
                ctx, cand, cfg.candidate_field)))
            check(out["ret_vs_fwd"] <= 1e-5,
                  f"FM factorised retrieval == forward ({out['ret_vs_fwd']})")
            mh = torch.from_numpy(multi_hot_ids(cfg.layout(), BAG_SHAPE, 4)
                                  ).to(dev)
            tree = model.tree()
            res["bag_err"] = 0.0
            for what in ("factors", "linear"):
                table = tree[what]["sharded"]
                for combiner in ("sum", "mean"):
                    with torch.inference_mode():
                        got = ops.embedding_bag(table, mh, combiner=combiner)
                        want = embedding_bag_plain(table, mh,
                                                   combiner=combiner)
                    e = max_diff(got, want)
                    check(e == 0.0, f"FM {what} multi-hot bags {BAG_SHAPE} "
                                    f"{combiner}: kernel vs plain diff {e}")
                    res["bag_err"] = max(res["bag_err"], e)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        res[name] = out
        del model
        torch.cuda.empty_cache()
    res["bag_launches"] = embedding_bag.launches
    res["bag_routes"] = dict(embedding_bag.routes)
    check(res["bag_launches"] == 4 and res["bag_routes"]["slots"] == 4,
          f"FM's narrow bags (D = 10 and D = 1) on the slots route: "
          f"{res['bag_launches']} launches, {res['bag_routes']}")
    torch.cuda.synchronize()
    return res


def phase_recsys_small(dev):
    """Phase 18: the three smoke configs on a small input, the CPU path
    against the card (same weights, made on the CPU): forward on 64 rows
    and retrieval of 128 candidates within 1e-5."""
    import importlib

    from repro_torch.configs import get_arch
    from repro_torch.data.batches import candidates
    from repro_torch.state import recsys_from_reference
    worst = 0.0
    for name in ("dlrm_mlperf", "fm", "xdeepfm"):
        arch = get_arch(name)
        cfg = arch.smoke_config()
        mod = importlib.import_module(f"repro_torch.models.{arch.model}")
        params = mod.init_params(cfg, torch.Generator().manual_seed(5),
                                 device="cpu")
        cpu = recsys_from_reference(cfg, params, device="cpu")
        gpu = recsys_from_reference(cfg, params, device=dev)
        batch = recsys_inputs(cfg, 64, 6)
        ctx = {k: v[:1] for k, v in batch.items()}
        ctx["candidates"] = candidates(
            128, cfg.field_sizes[cfg.candidate_field], seed=7)
        for what, a, b in (("forward", cpu(batch), gpu(batch)),
                           ("retrieval", cpu.retrieval_score(ctx),
                            gpu.retrieval_score(ctx))):
            e = max_diff(a, b.cpu())
            check(bool(torch.isfinite(a).all()), f"{name} {what} finite")
            check(e <= 1e-5, f"{name} {what} CPU vs card diff {e}")
            worst = max(worst, e)
    return worst


def bag_timing(name, table, ids, gather=None):
    """Kernel 9 at one shape of phase 16, held to its plain version bit
    for bit: the launch alone with the L2 cache flushed before every call
    (a serving caller finds the rows cold; CUDA events) and warm on the
    device alone, the wrapper with its id check back to back (CUDA
    events) and one call's host wall, the plain version, the library
    yardstick ``F.embedding_bag`` with the validity mask as
    ``per_sample_weights`` on clamped ids (never called by the port), cold
    and warm, ``gather`` (a gather of the same rows, for L = 1) cold and
    warm, and the bound (each distinct row, the ids and the output once).
    The timing launches leave the path's launch and route counts as they
    were."""
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_plain,
                                                   launch)
    b, l = ids.shape
    d = table.shape[1]
    n_bad = torch.zeros((1,), dtype=torch.int32, device=ids.device)
    valid = ids >= 0
    safe = ids.clamp_min(0)
    weights = valid.to(table.dtype)
    with torch.inference_mode():
        want = embedding_bag_plain(table, ids)
        err = max_diff(launch(table, ids, n_bad), want)
        check(err == 0.0, f"bag {name}: kernel vs plain diff {err}")
        launches, routes = embedding_bag.launches, dict(embedding_bag.routes)
        out = {"name": name, "err": err,
               "ms": time_ms_cold(lambda: launch(table, ids, n_bad), 50),
               "warm_ms": time_ms_queued(lambda: launch(table, ids, n_bad)),
               "wrapper_ms": time_ms(lambda: embedding_bag(table, ids), 50),
               "wrapper_host_ms": host_wall_ms(
                   lambda: embedding_bag(table, ids))}
        embedding_bag.launches, embedding_bag.routes = launches, routes
        out["plain_ms"] = time_ms_cold(
            lambda: embedding_bag_plain(table, ids), reps=5)

        def library_call():
            return F.embedding_bag(safe, table, mode="sum",
                                   per_sample_weights=weights)
        out["library_ms"] = time_ms_cold(library_call, reps=50)
        out["library_warm_ms"] = time_ms_queued(library_call)
        out["library_diff"] = max_diff(library_call(), want)
        if gather is not None:
            rows = gather(table, ids[:, 0])
            check(torch.equal(rows, want), f"bag {name}: gather == bags")
            out["gather_ms"] = time_ms_cold(lambda: gather(table, ids[:, 0]),
                                            50)
            out["gather_warm_ms"] = time_ms_queued(
                lambda: gather(table, ids[:, 0]))
    check(int(n_bad.item()) == 0, "no id past the table in the timing runs")
    distinct = int(torch.unique(ids[valid]).numel())
    n_valid = int(valid.sum())
    out["bound_ms"], out["bound_by"] = bound_ms(
        (distinct * d + b * d) * table.element_size() + b * l * 4.0,
        float(n_valid * d))
    out["shape"] = (f"B={b} L={l} ({n_valid} valid, {distinct} distinct "
                    f"rows) over {tuple(table.shape)} "
                    f"{str(table.dtype)[6:]}, sum")
    torch.cuda.synchronize()
    return out


def phase_bag_timings(dl, err):
    """Phase 16 (kernel 9) at the recsys paths' shapes: (a) phase 15's
    multi-hot launch (2048 bags × L = 100 over the fused 104 M × 128 f32
    table), (b) its L = 1 bags of serve_p99's lookups beside the serve
    step's own gather (``models/embedding.py::_take``), and the same
    multi-hot bags over FM's sharded (c) factor (D = 10) and (d) linear
    (D = 1) tables, made here as phase 17 makes them (seed 0); see
    :func:`bag_timing`.  Returns the kernels-line row (shape (a)'s
    numbers) with every shape's under ``shapes``."""
    from repro_torch.configs import get_arch
    from repro_torch.models import embedding as emb
    from repro_torch.models import fm
    fm_cfg = get_arch("fm").config
    fm_tables = fm.init_params(fm_cfg, torch.Generator(
        device=dl["multi_hot"].device).manual_seed(0))
    fm_ids = torch.from_numpy(multi_hot_ids(fm_cfg.layout(), BAG_SHAPE, 4)
                              ).to(dl["multi_hot"].device)
    table = dl["model"].tree()["tables"]["sharded"]
    shapes = [bag_timing("(a) multi-hot DLRM", table, dl["multi_hot"]),
              bag_timing("(b) L = 1 DLRM", table, dl["l1_ids"],
                         gather=emb._take),
              bag_timing("(c) multi-hot FM factors",
                         fm_tables["factors"]["sharded"], fm_ids),
              bag_timing("(d) multi-hot FM linear",
                         fm_tables["linear"]["sharded"], fm_ids)]
    a = shapes[0]
    return {"name": "embedding_bag", "route": "cuda",
            "source": "src/repro_torch/csrc/embedding_bag.cu",
            "replaces": "src/repro/kernels/embedding_bag.py:49",
            "launches": dl["launches"], "max_abs_err": err, "ms": a["ms"],
            "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
            "bound_by": a["bound_by"], "library_ms": a["library_ms"],
            "shape": a["shape"], "shapes": shapes}


def log_serving(name, out) -> None:
    p99 = out["p99_lat"]
    bulk = out["bulk_ms"]
    rows = out["bulk_rows"]
    log(f"    {name} serve_p99 (512 rows, {len(p99)} steps): p50 "
        f"{np.percentile(p99, 50):.3f} ms, p99 {np.percentile(p99, 99):.3f} "
        f"ms; serve_bulk ({rows} rows): {np.median(bulk):.2f} ms, "
        f"{rows / np.median(bulk) * 1e3:.0f} rows/s; retrieval "
        f"({out['ret_n']} candidates): "
        f"{np.median(out['ret_ms']):.2f} ms")


# the chaos bench's sizes (benchmarks/bench_chaos.py, full run)
CHAOS_U, CHAOS_D = 2048, 512
CHAOS_RECALL_U, CHAOS_RECALL_D = 8192, 1024
# BENCH_chaos.json: the reference's DEGRADED recall@20 at U = 8192
CHAOS_REF_RECALL = 1.0


def chaos_engine(dev, u, d, *, seed=0, n_clusters=32, n_probe=8,
                 shortlist=256):
    """The chaos bench's engine: cosine, k 40, block 256, both approx
    indexes, on the card."""
    from repro_torch.core.facade import CFEngine
    from repro_torch.data import load_ml1m_synthetic
    from repro_torch.index import IndexConfig, ItemIndexConfig
    train, _, _ = load_ml1m_synthetic(n_users=u, n_items=d)
    return CFEngine(train, measure="cosine", k=40, block_size=256,
                    neighbor_mode="approx", recommend_mode="approx",
                    index_cfg=IndexConfig(n_clusters=n_clusters,
                                          n_probe=n_probe, seed=seed,
                                          features="raw"),
                    item_index_cfg=ItemIndexConfig(shortlist=shortlist),
                    device=dev).fit()


def drain(futures, timeout=60.0):
    """(results, stranded): a future that neither resolves nor errors
    within the timeout is stranded."""
    out, stranded = [], 0
    for f in futures:
        try:
            out.append(f.result(timeout=timeout))
        except TimeoutError:
            out.append(None)
            stranded += 1
        except Exception as e:          # noqa: BLE001 - drill bookkeeping
            out.append(e)
    return out, stranded


def drill_serving(dev, u, d, *, waves, fail_batches):
    """Transient faults at configured batches under live traffic.  The
    reference bench's last wave runs under JAX's RetraceSentinel (a
    recompile check); the port compiles nothing per request, so that
    wave and its check are left out."""
    from repro_torch.distributed.fault_tolerance import (FaultInjector,
                                                         RecoveryPolicy)
    from repro_torch.serving.engine import BatchingServer
    eng = chaos_engine(dev, u, d)
    inj = FaultInjector(fail_at_steps=fail_batches)
    server = BatchingServer(
        eng, max_batch=8, max_wait_ms=5.0, topn=10,
        recovery=RecoveryPolicy(max_restarts=3, backoff_base_s=1e-3),
        fault_injector=inj, device=dev)
    server.start()
    rng = np.random.default_rng(0)
    wave_walls = []
    stranded = 0
    for _ in range(waves):
        t0 = time.perf_counter()
        futs = [server.submit(int(x)) for x in rng.integers(0, u, 8)]
        res, n_lost = drain(futs)
        stranded += n_lost
        wave_walls.append((time.perf_counter() - t0) * 1e3)
        stranded += sum(1 for r in res if isinstance(r, Exception))
    server.stop()
    st = server.stats()
    faulted = [wave_walls[b - 1] for b in fail_batches
               if b - 1 < len(wave_walls)]
    clean = [w for i, w in enumerate(wave_walls)
             if (i + 1) not in fail_batches]
    rec_ms = (float(np.mean(faulted) - np.mean(clean))
              if faulted and clean else 0.0)
    return {
        "requests": st["n_requests"],
        "injected_transient_faults": len(inj.fired),
        "failures": st["n_failures"],
        "retries": st["n_retries"],
        "recoveries": st["n_recoveries"],
        "stranded_futures": stranded,
        "recovery_latency_ms": max(rec_ms, 0.0),
        "p99_ms": st["latency_p99_ms"],
        "health": st["health"],
    }


def drill_admission(dev, u, d, *, max_queue, burst):
    """A burst past the high-water mark before the batcher starts: the
    overflow sheds, the admitted remainder serves."""
    from repro_torch.serving.engine import BatchingServer, Overloaded
    eng = chaos_engine(dev, u, d)
    server = BatchingServer(eng, max_batch=8, max_wait_ms=5.0, topn=10,
                            max_queue=max_queue, device=dev)
    rng = np.random.default_rng(1)
    futs, shed = [], 0
    for x in rng.integers(0, u, burst):
        try:
            futs.append(server.submit(int(x)))
        except Overloaded:
            shed += 1
    server.start()
    res, stranded = drain(futs)
    server.stop()
    stranded += sum(1 for r in res if isinstance(r, Exception))
    return {"burst": burst, "admitted": len(futs), "shed": shed,
            "shed_fraction": shed / burst, "stranded_futures": stranded,
            "health": server.stats()["health"]}


def drill_engine_recovery(dev, u, d, tmp):
    """Faults inside update_ratings and mid-refold; the last committed
    checkpoint (the port's ``checkpoint``) restores, and the re-applied
    update recommends bit for bit what a fault-free run does."""
    from repro_torch.distributed import checkpoint
    from repro_torch.distributed.fault_tolerance import (FaultInjector,
                                                         InjectedFault)
    rng = np.random.default_rng(2)
    users = np.arange(0, min(u, 64), dtype=np.int32)

    def recs(eng):
        s, i = eng.recommend(users, n=10)
        return s.cpu().numpy(), i.cpu().numpy()

    out = {}
    for name, hook in (("update", "engine"), ("refold", "index")):
        eng = chaos_engine(dev, u, d)
        upd = ([int(rng.integers(0, u))], [int(rng.integers(0, d))],
               [float(rng.integers(1, 6))])
        checkpoint.save(tmp, 1, eng.state())
        tpl = eng.state_template()
        eng.load_state(checkpoint.restore(tmp, 1, tpl))
        eng.update_ratings(*upd)
        ref_s, ref_i = recs(eng)
        eng.load_state(checkpoint.restore(tmp, 1, tpl))
        target = eng if hook == "engine" else eng.index
        seq = eng._update_seq if hook == "engine" else eng.index._refold_seq
        target.fault_injector = FaultInjector(fail_at_steps=(seq + 1,))
        t0 = time.perf_counter()
        try:
            eng.update_ratings(*upd)
            raise AssertionError("injected fault did not fire")
        except InjectedFault:
            pass
        target.fault_injector = None
        if hook == "index":
            try:
                eng.index.check_consistent(eng.ratings, eng.means)
                torn = False
            except RuntimeError:
                torn = True
            out["index_torn_before_restore"] = torn
        eng.load_state(checkpoint.restore(tmp, 1, tpl))
        if hook == "index":
            out["index_consistent_after_recovery"] = bool(
                eng.index.check_consistent(eng.ratings, eng.means))
        eng.update_ratings(*upd)
        torch.cuda.synchronize()
        rec_ms = (time.perf_counter() - t0) * 1e3
        got_s, got_i = recs(eng)
        out[f"bit_parity_{name}"] = bool(
            np.array_equal(got_i, ref_i) and np.array_equal(got_s, ref_s))
        out[f"recovery_latency_{name}_ms"] = rec_ms
    return out


def drill_degraded_recall(dev, u, d, *, topn=20):
    """Recall@n of the DEGRADED rung (the staged user-index mode and the
    budgets the ladder hands the batcher) against the full budget."""
    from repro_torch.serving.engine import DEGRADED, DegradationLadder
    eng = chaos_engine(dev, u, d)
    users = np.arange(u, dtype=np.int32)
    ref_i = eng.recommend(users, n=topn)[1].cpu().numpy()
    budget = DegradationLadder().budget(DEGRADED, eng.item_index.n_probe,
                                        eng.item_index.cfg.shortlist, topn)
    eng.index.query_mode_override = "staged"
    got_i = eng.recommend(users, n=topn, **budget)[1].cpu().numpy()
    eng.index.query_mode_override = None
    hits = total = 0
    for row in range(ref_i.shape[0]):
        ref = set(int(j) for j in ref_i[row] if j >= 0)
        hits += len(ref & set(int(j) for j in got_i[row]))
        total += len(ref)
    return {"users": u, "budget": budget,
            "recall_at20": hits / max(total, 1)}


def phase_chaos(dev):
    """Phase 19: the chaos bench's four drills on the port, at its full
    sizes, with the kernels' launch counts zeroed before and read
    after."""
    import tempfile
    zero_counts()
    t0 = time.perf_counter()
    out = {"serving": drill_serving(dev, CHAOS_U, CHAOS_D, waves=24,
                                    fail_batches=(2, 4, 6))}
    out["admission"] = drill_admission(dev, CHAOS_U, CHAOS_D, max_queue=16,
                                       burst=48)
    with tempfile.TemporaryDirectory() as tmp:
        out["engine"] = drill_engine_recovery(dev, CHAOS_U, CHAOS_D, tmp)
    out["degraded"] = drill_degraded_recall(dev, CHAOS_RECALL_U,
                                            CHAOS_RECALL_D)
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = {name: fn.launches
                       for name, fn in all_wrappers().items()}
    sv, ad, en, dg = (out["serving"], out["admission"], out["engine"],
                      out["degraded"])
    check(sv["stranded_futures"] == 0 and ad["stranded_futures"] == 0,
          f"no stranded futures ({sv['stranded_futures']}, "
          f"{ad['stranded_futures']})")
    check(sv["injected_transient_faults"] == 3
          and sv["recoveries"] >= sv["injected_transient_faults"],
          f"recoveries {sv['recoveries']} >= injected "
          f"{sv['injected_transient_faults']} (3)")
    check(ad["shed"] + ad["admitted"] == 48, f"shed + admitted == 48 ({ad})")
    check(en["bit_parity_update"] and en["bit_parity_refold"],
          f"bit parity through restore ({en})")
    check(en["index_torn_before_restore"]
          and en["index_consistent_after_recovery"],
          f"the mid-refold fault tore the index and the restore repaired "
          f"it ({en})")
    check(dg["recall_at20"] >= 0.90,
          f"DEGRADED recall@20 {dg['recall_at20']} >= 0.90")
    for name in ("cluster", "scan", "select", "rerank", "support"):
        check(out["launches"][name] > 0,
              f"{name} kernel launched in the chaos drills")
    return out


def phase_sharded(dev, train):
    """Phase 20: sharded execution on a one-rank NCCL mesh (the default
    mesh: a one-rank NCCL group over a file store, no network) at the
    paper's size (6040 × 3952, pcc, k = 40): ``CFEngine(backend=
    "sharded" | "ring")`` fits bitwise equal to ``backend="kernel"`` with
    every similarity launch on "imma", ``sharded_predict`` /
    ``ring_sharded_predict`` within 1e-5 of ``predict()`` (the first
    through the tile-predict kernel), recommend ids equal; a
    ``ClusteredIndex`` fitted through the mesh bit-identical to the
    unsharded fit with kernel 3 launched; the host support scorer's
    ``recommend(all, n=10)`` bitwise equal to the kernel scorer's and to
    the exact recommend at shortlist 512; FM's factor table (phase 17's
    config) through ``sharded_lookup(mesh=)`` == ``mesh=None``; and
    ``restore(shardings=)`` of the sharded engine's state onto the CUDA
    mesh == the numpy restore.  Each path's launch counts are zeroed just
    before it and read just after."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.core import engine as E
    from repro_torch.core import similarity as sim
    from repro_torch.core.facade import CFEngine
    from repro_torch.distributed import checkpoint as ck
    from repro_torch.distributed.sharding import PartitionSpec, to_shardings
    from repro_torch.index import ClusteredIndex, IndexConfig, ItemIndexConfig
    from repro_torch.kernels.similarity import fused_similarity
    from repro_torch.models import fm
    from repro_torch.models.embedding import sharded_lookup

    out = {"walls": {}, "launches": {}}
    wrappers = all_wrappers()
    mesh = E.default_mesh(dev)
    check(dist.get_backend() == "nccl" and mesh.device_type == "cuda"
          and mesh.size() == 1, f"a one-rank NCCL mesh ({dist.get_backend()}"
          f", {mesh.device_type}, {mesh.size()} ranks)")
    out["mesh"] = (f"{dist.get_backend()} world {dist.get_world_size()}, "
                   f"mesh {tuple(mesh.shape)} {mesh.mesh_dim_names}")

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out["walls"][name] = time.perf_counter() - t0
        return res

    def engine(backend, **kw):
        return CFEngine(train, measure="pcc", k=40, backend=backend,
                        device=dev, **kw).fit()

    ref = timed("kernel fit", lambda: engine("kernel"))
    ref_rec = ref.recommend(n=10)
    ref_pred = ref.predict()
    for backend in ("sharded", "ring"):
        zero_counts()
        fused_similarity.routes = dict.fromkeys(fused_similarity.routes, 0)
        eng = timed(f"{backend} fit",
                    lambda: engine(backend, mesh=mesh))
        rec = eng.recommend(n=10)
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in wrappers.items()}
        out["launches"][backend] = launches
        routes = dict(fused_similarity.routes)
        check(launches["similarity"] > 0
              and routes["imma"] == launches["similarity"],
              f"{backend}: every similarity launch on imma ({routes})")
        check(launches["predict"] > 0, f"{backend}: recommend through the "
                                       f"tile-predict kernel")
        check(torch.equal(eng.idx, ref.idx) and torch.equal(eng.scores,
                                                            ref.scores),
              f"{backend} fit == kernel fit, ids and scores bit for bit")
        check(torch.equal(rec[1], ref_rec[1]),
              f"{backend} recommend(n=10) ids == kernel backend's")
    r = ref.ratings
    zero_counts()
    p_sh = timed("sharded_predict",
                 lambda: E.sharded_predict(r, ref.scores, ref.idx, mesh))
    out["launches"]["sharded_predict"] = wrappers["predict"].launches
    check(wrappers["predict"].launches > 0,
          "sharded_predict through the tile-predict kernel")
    p_ring = timed("ring_sharded_predict", lambda: E.ring_sharded_predict(
        r, ref.scores, ref.idx, mesh))
    out["predict_err"] = (max_diff(p_sh, ref_pred), max_diff(p_ring,
                                                             ref_pred))
    check(max(out["predict_err"]) <= 1e-5,
          f"sharded / ring predict vs predict() {out['predict_err']}")
    del p_sh, p_ring, ref_pred

    # the user index fitted through the mesh
    means = sim.user_stats(r)[2]
    cfg = IndexConfig(features="centered")
    plain = ClusteredIndex(cfg).fit(r, means)
    zero_counts()
    meshed = timed("index fit through the mesh",
                   lambda: ClusteredIndex(cfg, mesh=mesh).fit(r, means))
    out["launches"]["index_fit"] = wrappers["cluster"].launches
    check(wrappers["cluster"].launches > 0,
          "the sharded k-means sweep launched kernel 3")
    check(torch.equal(meshed.centroids, plain.centroids)
          and np.array_equal(meshed.spill_ids, plain.spill_ids)
          and np.array_equal(meshed.spill_dist, plain.spill_dist),
          "index fit through the mesh == unsharded: centroids, spill ids "
          "and distances bit for bit")
    del plain, meshed

    # the host support scorer against the kernel scorer and exact
    rec = {}
    for mode in ("kernel", "support"):
        eng = engine("kernel", recommend_mode="approx",
                     item_index_cfg=ItemIndexConfig(shortlist_mode=mode))
        eng.recommend(n=10)                          # warm
        rec[mode] = timed(f"recommend(all, n=10) {mode} scorer",
                          lambda: eng.recommend(n=10))
    exact = eng.recommend(n=10, mode="exact")
    for name, want in (("kernel scorer", rec["kernel"]), ("exact", exact)):
        check(torch.equal(rec["support"][0], want[0])
              and torch.equal(rec["support"][1], want[1]),
              f"support scorer recommend(all, n=10) == {name}, bitwise")
    del eng, exact, rec

    # FM's factor table (phase 17's config) through the sharded lookup
    arch = get_arch("fm")
    cfg_fm = arch.config
    gen = torch.Generator(device=dev).manual_seed(0)
    factors = fm.init_params(cfg_fm, gen)["factors"]
    ids = torch.from_numpy(recsys_inputs(cfg_fm, 512, 0)["sparse"]).to(dev)
    zero_counts()
    got = sharded_lookup(cfg_fm.layout(), factors, ids, mesh=mesh)
    want = sharded_lookup(cfg_fm.layout(), factors, ids)
    check(torch.equal(got, want), "FM sharded_lookup(mesh=) == mesh=None "
                                  "bit for bit")
    out["lookup"] = f"{tuple(ids.shape)} ids -> {tuple(got.shape)}"
    del factors, got, want

    # restore onto the CUDA mesh
    state = ref.state()
    with tempfile.TemporaryDirectory() as tmp:
        ck.save(tmp, 1, state)
        like = ref.state_template()
        host = ck.restore(tmp, 1, like)
        specs = {k: (PartitionSpec("data", *[None] * (v.ndim - 1))
                     if isinstance(v, np.ndarray) and v.ndim else
                     PartitionSpec()) for k, v in state.items()
                 if not isinstance(v, dict)}
        specs.update({k: {} for k, v in state.items() if isinstance(v, dict)})
        placed = timed("restore onto the mesh", lambda: ck.restore(
            tmp, 1, like, shardings=to_shardings(mesh, specs)))
    n_leaves = 0
    for key, val in placed.items():
        if isinstance(val, dict):
            continue
        check(val.device_mesh is mesh and val.to_local().is_cuda,
              f"restored {key} is a DTensor on the CUDA mesh")
        check(np.array_equal(val.full_tensor().cpu().numpy(), host[key]),
              f"restored {key}: full_tensor() == the numpy restore")
        n_leaves += 1
    out["restored_leaves"] = n_leaves
    la = out["launches"]
    out["kernel_launches"] = {
        "fused_similarity": la["sharded"]["similarity"]
        + la["ring"]["similarity"],
        "fused_tile_predict": la["sharded"]["predict"]
        + la["ring"]["predict"] + la["sharded_predict"],
        "fused_centroid_distances": la["index_fit"]}
    torch.cuda.synchronize()
    return out


# BENCH_topk.json: the paper's Figs. 3-6 sweep (benchmarks/run.py: the
# ML-1M surrogate cut to 1024 x 768, seed 0, UserCF at block 256)
TOPK_FIG_SIZE = (1024, 768)
TOPK_FIG_MEASURES = ("jaccard", "cosine", "pcc")
TOPK_FIG_NS = (5, 10, 20, 40, 80)
# the cells of configs/cf_movielens.py that one card cannot hold: their
# f32 ratings alone are 1048576 x 65536 x 4 bytes = 256 GiB
CF_UNRUN_CELLS = ("fit_1m_users", "predict_bulk")


def phase_legacy(dev, train, test):
    """Phase 21: the paper's pipeline through the legacy path.  Each step
    zeroes the kernel launch counts before it and reads them after:

    1. ``UserCF(CFConfig(pcc, k 40))`` on the sequential engine at 6040 ×
       3952: the fit on kernel 1 ("imma"), bit for bit the facade's
       kernel fit; ``predict`` one kernel-2 launch ("int8") bit for bit
       the plain blocked predict on the card; ``evaluate``;
    2. the paper's Figs. 3-6 at ``BENCH_topk.json``'s size: 15 fits and
       evaluations held to the file (precision, recall, F1 and MAE within
       1e-6);
    3. the legacy ``BatchingServer(cf, ratings)``: 512 requests through
       kernel 2, ids equal to the facade server's;
    4. ``UserCF`` on the sharded and ring engines over the one-rank NCCL
       mesh: fits bit for bit the sequential one, kernels 1 and 2;
    5. Slope One: the deviations on the card bit for bit the CPU's at
       full size and through ``sharded_deviation``; ``predict`` within
       2e-6 of the CPU on a small input; ``evaluate``;
    6. ``cf_movielens``'s ``fit_ml1m`` through ``build_step`` (the ring
       engine, the users padded to 6144 with zero rows) bit for bit
       ``UserCF``'s sequential fit; its ``cf_predict`` step within 1e-5
       of ``UserCF.predict``; the plans of the two cells one card cannot
       hold, built and not run."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.core import engine as E
    from repro_torch.core import predict as pr
    from repro_torch.core import slope_one as so
    from repro_torch.core.cf_model import CFConfig, UserCF
    from repro_torch.core.facade import CFEngine
    from repro_torch.data import load_ml1m_synthetic
    from repro_torch.kernels.predict import fused_tile_predict
    from repro_torch.kernels.similarity import fused_similarity
    from repro_torch.launch.steps import build_step
    from repro_torch.serving.engine import BatchingServer

    out = {"walls": {}, "launches": {}}
    wrappers = all_wrappers()
    train_t = torch.from_numpy(train).to(dev)
    test_t = torch.from_numpy(test).to(dev)

    def counted(step, fn):
        """``fn()`` with every count zeroed before and read after; the
        similarity and tile-predict counts (and routes) are kept."""
        zero_counts()
        fused_similarity.routes = dict.fromkeys(fused_similarity.routes, 0)
        fused_tile_predict.routes = dict.fromkeys(fused_tile_predict.routes,
                                                  0)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out["walls"][step] = time.perf_counter() - t0
        la = {n: f.launches for n, f in wrappers.items() if f.launches}
        la["similarity_routes"] = {k: v for k, v in
                                   fused_similarity.routes.items() if v}
        la["predict_routes"] = {k: v for k, v in
                                fused_tile_predict.routes.items() if v}
        out["launches"][step] = la
        return res, la

    def on_routes(la, what, sim=True, pred=True):
        if sim:
            check(la.get("similarity", 0) > 0
                  and la["similarity_routes"] == {
                      "imma": la["similarity"]},
                  f"{what}: kernel 1 launched, every launch on imma ({la})")
        if pred:
            check(la.get("predict", 0) > 0
                  and la["predict_routes"] == {"int8": la["predict"]},
                  f"{what}: kernel 2 launched, every launch on int8 ({la})")

    # 1. the sequential engine at the paper's size
    cf = UserCF(CFConfig(measure="pcc", top_k=40), device=dev)
    st, la = counted("sequential fit", lambda: cf.fit(train_t))
    on_routes(la, "UserCF sequential fit", pred=False)
    check(set(la) == {"similarity", "similarity_routes", "predict_routes"},
          f"the fit launches kernel 1 only ({la})")
    out["fit_s"] = st.fit_seconds
    out["fit_warm_s"] = cf.fit(train_t).fit_seconds
    st = cf.state
    ref = CFEngine(train, measure="pcc", k=40, backend="kernel", device=dev)
    ref.fit()
    check(torch.equal(st.idx, ref.idx) and torch.equal(st.scores,
                                                       ref.scores),
          "UserCF sequential fit == CFEngine(backend='kernel') fit, ids and "
          "scores bit for bit")
    pred, la = counted("predict", lambda: cf.predict(train_t))
    on_routes(la, "UserCF predict", sim=False)
    check(la.get("predict") == 1, f"predict is one kernel-2 launch ({la})")
    plain = pr.predict_from_neighbors_blocked(
        train_t, st.scores, st.idx, means=st.means,
        gather_src=pr.make_gather_source(train_t), use_kernel=False)
    check(torch.equal(pred.view(torch.int32), plain.view(torch.int32)),
          "UserCF predict == the plain blocked predict, bit for bit")
    del plain
    ev, la = counted("evaluate", lambda: cf.evaluate(train_t, test_t))
    on_routes(la, "UserCF evaluate", sim=False)
    out["evaluate"] = ev
    check(0.3 < ev["mae"] < 1.5 and all(math.isfinite(v)
                                        for v in ev.values()),
          f"evaluate: finite, MAE in range ({ev})")

    # 2. the paper's Figs. 3-6 against BENCH_topk.json
    with open(os.path.join(ROOT, "BENCH_topk.json")) as f:
        want = {row["name"]: row for row in json.load(f)}
    ftr, fte, _ = load_ml1m_synthetic(n_users=TOPK_FIG_SIZE[0],
                                      n_items=TOPK_FIG_SIZE[1], seed=0)
    ftr, fte = torch.from_numpy(ftr).to(dev), torch.from_numpy(fte).to(dev)

    def sweep():
        rows = {}
        for measure in TOPK_FIG_MEASURES:
            for k in TOPK_FIG_NS:
                m = UserCF(CFConfig(measure=measure, top_k=k,
                                    block_size=256), device=dev)
                m.fit(ftr)
                rows[f"topn_{measure}_k{k}"] = m.evaluate(ftr, fte)
        return rows
    rows, la = counted("figs 3-6 sweep", sweep)
    on_routes(la, "the Figs. 3-6 sweep")
    fig_err = {key: 0.0 for key in ("mae", "precision", "recall", "f1")}
    for name, got in rows.items():
        for key in fig_err:
            fig_err[key] = max(fig_err[key], abs(got[key] - want[name][key]))
    out["figs"] = {name: {key: rows[name][key] for key in fig_err}
                   for name in rows}
    out["figs_err"] = fig_err
    check(len(rows) == 15 and max(fig_err.values()) <= TOL,
          f"Figs. 3-6 against BENCH_topk.json: max |diff| {fig_err} "
          f"(tolerance {TOL})")
    del ftr, fte

    # 3. the legacy server against the facade server
    req = np.random.default_rng(0).integers(0, train.shape[0], 512)

    def serve(server):
        server.start()
        t0 = time.perf_counter()
        futs = [server.submit(int(u)) for u in req]
        res = [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
        server.stop()
        st_ = server.stats()
        check(len(res) == 512 and st_["n_failures"] == 0,
              "every served future resolves")
        return res, {"req_per_s": 512 / wall,
                     "p50_ms": st_["latency_p50_ms"],
                     "p99_ms": st_["latency_p99_ms"],
                     "batches": st_["n_batches"]}
    (legacy, out["legacy_serving"]), la = counted(
        "legacy server", lambda: serve(BatchingServer(
            cf, train_t, max_batch=32, topn=10, device=dev)))
    on_routes(la, "the legacy server", sim=False)
    facade, out["facade_serving"] = serve(BatchingServer(
        ref, max_batch=32, topn=10, device=dev))
    check(all(a.user == b.user and np.array_equal(a.items, b.items)
              for a, b in zip(legacy, facade)),
          "legacy server ids == facade server ids, every request")
    want_rec = cf.recommend(train_t, n=10)[1][torch.as_tensor(
        req, device=dev)]
    check(all(np.array_equal(a.items, w) for a, w in
              zip(legacy, want_rec.cpu().numpy())),
          "legacy server ids == UserCF.recommend")
    del ref, want_rec

    # 4. the mesh engines on the one-rank NCCL mesh
    mesh = E.default_mesh(dev)
    check(dist.get_backend() == "nccl" and mesh.device_type == "cuda",
          "a one-rank NCCL mesh")
    for engine in ("sharded", "ring"):
        mcf = UserCF(CFConfig(measure="pcc", top_k=40, engine=engine),
                     mesh, device=dev)
        (mst, mpred), la = counted(
            f"{engine} fit + predict",
            lambda: (mcf.fit(train_t), mcf.predict(train_t)))
        on_routes(la, f"UserCF {engine}")
        check(torch.equal(mst.idx, st.idx) and torch.equal(mst.scores,
                                                           st.scores),
              f"UserCF {engine} fit == sequential, bit for bit")
        check(torch.equal(mpred.view(torch.int32), pred.view(torch.int32)),
              f"UserCF {engine} predict (sharded_predict) == sequential")
        out[f"{engine}_fit_s"] = mst.fit_seconds
    del pred, mpred

    # 5. Slope One
    (dev_c, cnt_c), la = counted("slope one deviation",
                                 lambda: so.deviation_matrix(train_t))
    dev_h, cnt_h = so.deviation_matrix(torch.from_numpy(train))
    check(torch.equal(dev_c.cpu(), dev_h) and torch.equal(cnt_c.cpu(),
                                                          cnt_h),
          "Slope One deviation_matrix: card == CPU, bit for bit, at full "
          "size")
    sd, sc = so.sharded_deviation(train_t, mesh)
    check(torch.equal(sd, dev_c) and torch.equal(sc, cnt_c),
          "sharded_deviation on the mesh == deviation_matrix")
    del dev_h, cnt_h, sd, sc, dev_c, cnt_c
    small, small_te, _ = load_ml1m_synthetic(n_users=384, n_items=300,
                                             seed=0)
    cpu_m = so.SlopeOne(device="cpu").fit(small)
    card_m = so.SlopeOne(device=dev).fit(small)
    out["slope_small_err"] = max_diff(card_m.predict(small).cpu(),
                                      cpu_m.predict(small))
    check(out["slope_small_err"] <= 2e-6,
          f"Slope One predict card vs CPU {out['slope_small_err']}")
    t0 = time.perf_counter()
    slope = so.SlopeOne(device=dev).fit(train_t)
    out["slope_eval"] = slope.evaluate(train_t, test_t)
    torch.cuda.synchronize()
    out["slope_s"] = time.perf_counter() - t0
    check(0.3 < out["slope_eval"]["mae"] < 1.5,
          f"Slope One MAE {out['slope_eval']}")
    del slope, cpu_m, card_m

    # 6. the cf_movielens steps
    arch = get_arch("cf_movielens")
    cell = arch.cell("fit_ml1m")
    users, items = cell.dims["users"], cell.dims["items"]
    check(items == train.shape[1] and users >= train.shape[0],
          f"fit_ml1m {users} x {items} holds the surrogate")
    padded = torch.cat([train_t, torch.zeros(
        (users - train.shape[0], items), device=dev)])
    (s, i), la = counted("cf_fit step", lambda: build_step(
        arch, cell, mesh).fn({"ratings": padded}))
    on_routes(la, "the cf_fit step (ring)", pred=False)
    seq = UserCF(dataclasses.replace(arch.config, engine="sequential"),
                 device=dev)
    pst = seq.fit(padded)
    check(torch.equal(i, pst.idx) and torch.equal(s, pst.scores),
          f"cf_fit step at {users} x {items} == UserCF sequential, bit for "
          f"bit")
    step_pred, la = counted("cf_predict step", lambda: build_step(
        arch, arch.cell("predict_bulk"), mesh).fn({"ratings": padded}, s, i))
    out["step_predict_err"] = max_diff(step_pred, seq.predict(padded))
    check(out["step_predict_err"] <= 1e-5,
          f"cf_predict step vs UserCF.predict {out['step_predict_err']}")
    out["step_shape"] = f"{users} x {items} ({users - train.shape[0]} zero " \
                        f"users padded)"
    out["unrun"] = {}
    for name in CF_UNRUN_CELLS:
        plan = build_step(arch, arch.cell(name), mesh)
        spec = plan.example_args["ratings"]
        gib = math.prod(spec.shape) * 4 / 2**30
        out["unrun"][name] = (f"{plan.name}: {dict(plan.example_args)}; "
                              f"not run (f32 ratings {gib:.0f} GiB)")
    del padded, s, i, step_pred, seq, pst
    la = out["launches"]
    out["kernel_launches"] = {
        "fused_similarity": sum(v.get("similarity", 0) for v in la.values()),
        "fused_tile_predict": sum(v.get("predict", 0) for v in la.values())}
    torch.cuda.synchronize()
    return out


# kernel 8's backward and the training slice (phases 22-24)
FLASH_BWD_SHAPE = (4, 32, 8, 2048, 64)   # Llama-3.2-1B's prefill: B, Hq,
#                                          Hkv, S, d
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
LM_TRAIN_SHAPE = (4, 4096)      # train_4k's seq 4096, batch cut from 256
LM_TRAIN_MICROBATCH = 2
LM_TRAIN_STEPS = 4
DLRM_TRAIN_ROW_CAP = 2_000_000  # rows per DLRM field for training
XDEEPFM_TRAIN_ROWS = 8192       # xDeepFM train_batch rows (cut from 65536)
B4R_BULK_ROWS = 32_768          # BERT4Rec serve_bulk rows (cut from 262144)
B4R_TRAIN_ROWS = 2048           # BERT4Rec train_batch rows (cut from 65536)
RECSYS_TRAIN_STEPS = 3


def bwd_close(name, q, k, v, route, seed=7):
    """Kernel 8's forward (with its log-sum-exp), then its backward kernel
    on ``route`` against the plain backward (softmax recomputed, no lse)
    on f32 copies of the same inputs: each of dQ, dK, dV within
    ``BWD_TOL[dtype]`` of the largest |gradient| of that tensor (the
    kernel sums in f32 in another order; bf16 gradients are rounded
    once, ≤ 2⁻⁸ of each value, and the "mma" route rounds P and dS once
    to bf16 as an operand); then a second call must give the same bits
    (no atomics).  Returns (max abs diff, max relative diff, o, do,
    lse)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain)
    o, lse = flash_attention(q, k, v, return_lse=True)
    gen = torch.Generator(device=q.device).manual_seed(seed)
    do = torch.randn(o.shape, generator=gen, device=q.device).to(q.dtype)
    before = flash_attention_bwd.launches
    routes = dict(flash_attention_bwd.routes)
    got = flash_attention_bwd(q, k, v, o, do, lse)
    check(flash_attention_bwd.launches == before + 1,
          f"{name}: one backward launch")
    check(flash_attention_bwd.routes == {
        r: n + (r == route) for r, n in routes.items()},
        f"{name}: route {route}, counts {flash_attention_bwd.routes}")
    again = flash_attention_bwd(q, k, v, o, do, lse)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{name}: two calls bitwise equal")
    del again
    want = flash_attention_bwd_plain(*(t.float() for t in (q, k, v, o, do)))
    err = rel = 0.0
    for tag, g, w, x in zip("qkv", got, want, (q, k, v)):
        check(g.dtype == x.dtype and g.shape == x.shape,
              f"{name} d{tag} dtype / shape")
        e = max_diff(g, w)
        r = e / max(1.0, float(w.abs().max()))
        check(r <= BWD_TOL[q.dtype],
              f"{name} d{tag}: diff {e} ({r} of the largest |grad|)")
        err, rel = max(err, e), max(rel, r)
    return err, rel, o, do, lse


# the forward's log-sum-exp against the plain version's, absolute: f32
# inputs, bf16 inputs (both sum exp in f32 from the same values)
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}


def lse_close(name, q, k, v, route, **kw):
    """The forward on ``route`` with ``return_lse=True``: its output equal
    to the call without lse bit for bit, its lse within ``LSE_TOL`` of the
    plain version's on f32 copies.  Returns the max abs diff."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    before = flash_attention.routes[route]
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    check(flash_attention.routes[route] == before + 1, f"{name}: {route}")
    check(torch.equal(out, flash_attention(q, k, v, **kw)),
          f"{name}: the output does not depend on return_lse")
    want = flash_attention_plain(q.float(), k.float(), v.float(),
                                 return_lse=True, **kw)[1]
    e = max_diff(lse, want)
    check(e <= LSE_TOL[q.dtype], f"{name} lse: diff {e}")
    return e


def phase_flash_bwd(dev):
    """Phase 22: kernel 8's backward (``csrc/flash_attention_bwd.cu``)
    against its plain version at Llama-3.2-1B's prefill shapes on both
    routes — bf16 on "mma", f32 on "simt" — each twice, bitwise equal;
    the forward's log-sum-exp on each of its routes (prefill "simt" and
    "mma", decode "split") against the plain version's, and its prefill
    and decode times with lse off and on; the backward's time against
    the plain version, autograd of
    ``scaled_dot_product_attention(enable_gqa=True)``'s backward (never
    called by the port) and both bounds at the bf16 peak: the function's
    five products (the forward's two matmuls: S, dV, dP, dQ, dK), and the
    seven the deterministic design runs (dQ's kernel recomputes S and
    dP), half of each causal-masked."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain)

    b, hq, hkv, s, d = FLASH_BWD_SHAPE
    gen = torch.Generator(device=dev).manual_seed(22)
    out = {"errs": {}, "lse_errs": {}, "fwd": {}}
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((b, hq, s, d), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((b, hkv, s, d), generator=gen,
                            device=dev).to(dtype) for _ in range(2))
        tag = str(dtype)[6:]
        route = "simt" if dtype == torch.float32 else "mma"
        err, rel, o, do, lse = bwd_close(f"flash bwd {tag}", q, k, v, route)
        out["errs"][tag] = (err, rel)
        out["lse_errs"][f"{tag} {route}"] = lse_close(
            f"flash {tag} prefill", q, k, v, route)
        if dtype == torch.bfloat16:
            out["route"] = route
            out["max_abs_err"] = err
            out["ms"] = time_ms(lambda: flash_attention_bwd(
                q, k, v, o, do, lse), reps=10)
            out["plain_ms"] = time_ms(lambda: flash_attention_bwd_plain(
                q, k, v, o, do), reps=2)
            ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
            lib_out = F.scaled_dot_product_attention(
                ql, kl, vl, is_causal=True, enable_gqa=True)
            out["library_ms"] = time_ms(lambda: torch.autograd.grad(
                lib_out, (ql, kl, vl), do, retain_graph=True), reps=5)
            del ql, kl, vl, lib_out
            # the forward with its log-sum-exp off (serving) and on
            # (training), and a decode launch (Sq 1, kv_len 2049 of 2080)
            kc, vc = (torch.randn((b, hkv, s + 32, d), generator=gen,
                                  device=dev).to(dtype) for _ in range(2))
            qd = q[:, :, -1:].contiguous()
            kv_len = torch.full((b,), s + 1, dtype=torch.int32, device=dev)
            out["lse_errs"]["bf16 split"] = lse_close(
                "flash bf16 decode", qd, kc, vc, "split", kv_len=kv_len)
            fw = out["fwd"]
            for lse_on in (False, True):
                key = "lse on" if lse_on else "lse off"
                fw[f"prefill {key}"] = time_ms(lambda: flash_attention(
                    q, k, v, return_lse=lse_on), reps=20)
                fw[f"decode {key} (device)"] = time_ms_queued(
                    lambda: flash_attention(qd, kc, vc, kv_len=kv_len,
                                            return_lse=lse_on))
            del kc, vc, qd
        else:
            out["f32_route"] = route
            out["f32_ms"] = time_ms(
                lambda: flash_attention_bwd(q, k, v, o, do, lse), reps=3)
        del q, k, v, o, do, lse
    pairs = b * hq * s * (s + 1) / 2
    n_bytes = (4 * b * hq * s * d + 4 * b * hkv * s * d) * 2.0
    out["bound_ms"], out["bound_by"] = bound_ms(
        n_bytes, 5 * 2.0 * pairs * d, PEAK_BF16_OPS_PER_S)
    out["floor7_ms"] = bound_ms(n_bytes, 7 * 2.0 * pairs * d,
                                PEAK_BF16_OPS_PER_S)[0]
    out["shape"] = (f"B={b} Hq={hq} Hkv={hkv} S={s} d={d} bf16 causal")
    torch.cuda.synchronize()
    return out


def grad_readings(kern, plain):
    """Per-leaf ‖Δg‖ / ‖g‖ of two gradient trees (sorted leaf order)."""
    from repro_torch.distributed.checkpoint import tree_flatten
    out = []
    for a, b in zip(tree_flatten(kern), tree_flatten(plain)):
        a, b = a.double(), b.double()
        out.append(float((a - b).norm() / b.norm().clamp_min(1e-30)))
    return out


def lm_train_cell():
    """Phase 23's arch and cell: Llama-3.2-1B with ``LM_TRAIN_MICROBATCH``
    µbatches and remat, train_4k's seq with the batch cut to
    ``LM_TRAIN_SHAPE``'s."""
    import dataclasses

    from repro_torch.configs import get_arch
    b, s = LM_TRAIN_SHAPE
    arch = get_arch("llama3_2_1b")
    cfg = dataclasses.replace(arch.config, microbatch=LM_TRAIN_MICROBATCH,
                              remat=True)
    arch = dataclasses.replace(arch, config=cfg)
    return arch, dataclasses.replace(arch.cell("train_4k"),
                                     name=f"train_4k_b{b}",
                                     dims={"batch": b, "seq": s})


def phase_lm_train(dev):
    """Phase 23: Llama-3.2-1B trained at full width (f32 master weights,
    bf16 compute, AdamW, remat, the tied embedding), train_4k's seq 4096
    with the batch cut to 4 in 2 µbatches: first one step's loss and
    per-leaf gradients through kernel 8 (forward and backward) against
    the plain attention on the same weights and batch, then 4
    ``build_step`` train steps with the launch counts zeroed before and
    read after."""
    import dataclasses

    from repro_torch.data.batches import lm_batch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.launch.steps import build_step
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tx
    from repro_torch.training.train_loop import take_grads, trainable

    b, s = LM_TRAIN_SHAPE
    arch, cell = lm_train_cell()
    cfg = arch.config
    plan = build_step(arch, cell)
    out = {"reduced": [f"train_4k batch {arch.cell('train_4k').dims['batch']}"
                       f" -> {b} ({LM_TRAIN_MICROBATCH} µbatches of "
                       f"{b // LM_TRAIN_MICROBATCH})",
                       f"{LM_TRAIN_STEPS} steps"]}
    gen = torch.Generator(device=dev).manual_seed(0)
    model = tx.Transformer(cfg, tx.init_params(cfg, gen))
    out["params"] = cm.count_params(model)
    check(out["params"] == cfg.param_count(), "parameter count")
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                lm_batch(b, s, cfg.vocab, seed=i).items()}
               for i in range(LM_TRAIN_STEPS)]

    # one step's loss and gradients, kernel path vs plain attention, on
    # the same weights and batch: in f32 compute (the kernels' "simt"
    # forward route and the f32 backward) against the 1e-2 limit, and in
    # the trained bf16 config each path against the f32 plain gradient
    tree = trainable(model.tree())
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)

    def grads_of(c, use_kernel):
        t0 = time.perf_counter()
        loss = float(tx.backward(c, tree, batches[0], use_kernel=use_kernel))
        grads = take_grads(tree)
        torch.cuda.synchronize()
        return loss, grads, time.perf_counter() - t0

    lt, gt, out["grad_s_f32_plain"] = grads_of(cfg32, False)
    lk, gk, out["grad_s_f32_kernel"] = grads_of(cfg32, True)
    out["f32_loss"] = (lk, lt)
    out["f32_loss_rel"] = abs(lk - lt) / abs(lt)
    out["f32_grad_rel"] = grad_readings(gk, gt)
    del gk
    check(math.isfinite(lk) and out["f32_loss_rel"] <= 1e-3,
          f"f32 compute: loss kernel {lk} vs plain {lt} "
          f"({out['f32_loss_rel']} relative)")
    check(max(out["f32_grad_rel"]) <= 1e-2,
          f"f32 compute: per-leaf ‖Δg‖/‖g‖ {out['f32_grad_rel']} ≤ 1e-2")
    lk, gk, out["grad_s_kernel"] = grads_of(cfg, True)
    lp, gp, out["grad_s_plain"] = grads_of(cfg, False)
    out["loss_kernel"], out["loss_plain"] = lk, lp
    out["loss_rel"] = abs(lk - lp) / abs(lp)
    out["grad_rel"] = grad_readings(gk, gp)
    out["kernel_vs_f32"] = grad_readings(gk, gt)
    out["plain_vs_f32"] = grad_readings(gp, gt)
    del gk, gp, gt
    check(math.isfinite(lk) and out["loss_rel"] <= 1e-3,
          f"loss kernel {lk} vs plain {lp}: {out['loss_rel']} relative")
    check(all(k <= 1.5 * p + 1e-5 for k, p in zip(out["kernel_vs_f32"],
                                                  out["plain_vs_f32"])),
          f"bf16: the kernel path's per-leaf distance to the f32 gradient "
          f"{out['kernel_vs_f32']} ≤ 1.5 × the plain path's + 1e-5 "
          f"{out['plain_vs_f32']}")

    state = plan.optimizer.init(model.tree())
    zero_counts()
    # the card's peak over the timed steps alone (phase 29 holds the dry
    # run's estimate to it)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["reset_bytes"] = torch.cuda.memory_allocated()
    losses, walls = [], []
    for i in range(LM_TRAIN_STEPS):
        t0 = time.perf_counter()
        model, state, loss = plan.fn(model, state, batches[i])
        losses.append(float(loss))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out["losses"], out["walls"] = losses, walls
    out["first_s"] = walls[0]
    out["warm_s"] = float(np.mean(walls[1:]))
    out["tokens_per_s"] = b * s / out["warm_s"]
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["peak_gib"] = out["peak_bytes"] / 2**30
    out["launches"] = {"forward": flash_attention.launches,
                       "backward": flash_attention_bwd.launches}
    out["bwd_routes"] = dict(flash_attention_bwd.routes)
    per_step = cfg.n_layers * LM_TRAIN_MICROBATCH
    check(out["bwd_routes"]["mma"] == out["launches"]["backward"],
          f"every backward launch on \"mma\": {out['bwd_routes']}")
    check(out["launches"]["backward"] == per_step * LM_TRAIN_STEPS,
          f"one backward launch a layer and µbatch: {out['launches']}")
    check(out["launches"]["forward"] == 2 * per_step * LM_TRAIN_STEPS,
          f"forward and remat recompute launches: {out['launches']}")
    check(all(math.isfinite(x) for x in losses), f"finite losses {losses}")
    check(int(state["step"]) == LM_TRAIN_STEPS, "optimizer step count")
    out["profile"] = profile_each(((
        f"LM train step ({b} x {s}, {LM_TRAIN_MICROBATCH} µbatches)",
        lambda: plan.fn(model, state, batches[0]), 10),))[0]
    del model, state, tree, batches
    torch.cuda.synchronize()
    return out


def train_steps(plan, model, batches):
    """``plan``'s train step over ``batches`` from a fresh optimizer
    state: (losses, host-clock seconds a step, the loss on the first
    batch before and after)."""
    state = plan.optimizer.init(model.tree())
    with torch.no_grad():
        before = float(model.loss_fn(model.cfg, model.tree(), batches[0]))
    losses, walls = [], []
    for batch in batches:
        t0 = time.perf_counter()
        model, state, loss = plan.fn(model, state, batch)
        losses.append(float(loss))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with torch.no_grad():
        after = float(model.loss_fn(model.cfg, model.tree(), batches[0]))
    check(all(math.isfinite(x) for x in losses + [before, after]),
          f"{plan.name}: finite losses {losses}, {before} -> {after}")
    check(int(state["step"]) == len(batches), f"{plan.name}: step count")
    return {"losses": losses, "walls": walls, "before": before,
            "after": after}


def phase_recsys_train(dev):
    """Phase 24: DLRM (fields capped at ``DLRM_TRAIN_ROW_CAP`` rows), FM
    and xDeepFM (train_batch cut to ``XDEEPFM_TRAIN_ROWS``) a few Adagrad
    steps each; BERT4Rec at its published config: serve_p99 and
    retrieval_cand uncut, serve_bulk and train_batch cut, a few AdamW
    steps; then a short ``train_loop.run`` on BERT4Rec with a checkpoint
    directory and an injected fault (one recovery), and a second run on
    the same directory that resumes."""
    import dataclasses
    import tempfile

    from repro_torch import obs
    from repro_torch.configs import get_arch
    from repro_torch.data.batches import (bert4rec_batch, candidates,
                                          recsys_batch)
    from repro_torch.distributed.fault_tolerance import FaultInjector
    from repro_torch.launch.steps import build_step
    from repro_torch.models import bert4rec, dlrm, fm, xdeepfm
    from repro_torch.models import common as cm
    from repro_torch.training.train_loop import (TrainLoopConfig,
                                                 make_train_step, run)

    def on_dev(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    res = {}
    for name, mod, cls in (("dlrm_mlperf", dlrm, dlrm.DLRM),
                           ("fm", fm, fm.FM),
                           ("xdeepfm", xdeepfm, xdeepfm.XDeepFM)):
        arch = get_arch(name)
        cfg, reduced = arch.config, []
        if name == "dlrm_mlperf":
            reduced = [f"field {i}: {s} -> {DLRM_TRAIN_ROW_CAP} rows"
                       for i, s in enumerate(cfg.field_sizes)
                       if s > DLRM_TRAIN_ROW_CAP]
            cfg = dataclasses.replace(cfg, field_sizes=tuple(
                min(s, DLRM_TRAIN_ROW_CAP) for s in cfg.field_sizes))
            arch = dataclasses.replace(arch, config=cfg)
        cell = arch.cell("train_batch")
        rows = cell.dims["batch"]
        if name == "xdeepfm":
            reduced.append(f"train_batch {rows} -> {XDEEPFM_TRAIN_ROWS} "
                           f"rows (the CIN's saved outer products)")
            rows = XDEEPFM_TRAIN_ROWS
            cell = dataclasses.replace(cell, dims={"batch": rows})
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev).manual_seed(0)
        model = cls(cfg, mod.init_params(cfg, gen))
        plan = build_step(arch, cell)
        batches = [on_dev(recsys_batch(rows, cfg.field_sizes,
                                       getattr(cfg, "n_dense", 0),
                                       seed=10 + i))
                   for i in range(RECSYS_TRAIN_STEPS)]
        out = train_steps(plan, model, batches)
        out.update(params=cm.count_params(model), rows=rows,
                   reduced=reduced, optimizer=arch.optimizer,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        res[name] = out
        del model, plan, batches
        gc.collect()
        torch.cuda.empty_cache()

    arch = get_arch("bert4rec")
    cfg = arch.config
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = bert4rec.BERT4Rec(cfg, bert4rec.init_params(cfg, gen))
    out = {"params": cm.count_params(model), "reduced": []}
    check(out["params"] == cfg.param_count(), "BERT4Rec parameter count")

    def items(rows, seed):
        return bert4rec_batch(rows, cfg.seq_len, cfg.n_items,
                              cfg.mask_token, seed=seed)

    serve = build_step(arch, arch.cell("serve_p99"))
    p99 = {"items": items(arch.cell("serve_p99").dims["batch"], 0)["items"]}
    lat, scores = serve_latencies(serve, model, p99, 30)
    check(tuple(scores.shape) == (len(p99["items"]), cfg.vocab)
          and bool(torch.isfinite(scores).all()),
          "BERT4Rec serve_p99 scores finite (B, vocab)")
    out["p99_lat"] = lat
    bulk_cell = arch.cell("serve_bulk")
    out["reduced"].append(
        f"serve_bulk {bulk_cell.dims['batch']} -> {B4R_BULK_ROWS} rows (the "
        f"(B, 2, 200, 200) f32 attention of 262144 rows is 84 GB)")
    bulk_cell = dataclasses.replace(bulk_cell, dims={"batch": B4R_BULK_ROWS})
    bulk = build_step(arch, bulk_cell)
    lat, scores = serve_latencies(bulk, model, {"items": items(
        B4R_BULK_ROWS, 1)["items"]}, 3, warm=1)
    check(bool(torch.isfinite(scores).all()), "BERT4Rec serve_bulk finite")
    out["bulk_ms"], out["bulk_rows"] = lat, B4R_BULK_ROWS
    ret_cell = arch.cell("retrieval_cand")
    n = ret_cell.dims["n_candidates"]
    ret = build_step(arch, ret_cell)
    one = {"items": p99["items"][:1],
           "candidates": candidates(n, cfg.vocab, seed=3)}
    lat, scores = serve_latencies(ret, model, one, 3, warm=1)
    check(tuple(scores.shape) == (n,) and bool(torch.isfinite(scores).all()),
          f"BERT4Rec retrieval scores finite ({n},)")
    want = model({"items": one["items"]})[0, torch.from_numpy(
        one["candidates"]).long().to(dev)]
    out["ret_vs_serve"] = max_diff(scores, want)
    check(out["ret_vs_serve"] <= 1e-5,
          f"BERT4Rec retrieval == serve scores ({out['ret_vs_serve']})")
    out["ret_ms"], out["ret_n"] = lat, n
    train_cell = arch.cell("train_batch")
    out["reduced"].append(
        f"train_batch {train_cell.dims['batch']} -> {B4R_TRAIN_ROWS} rows "
        f"(the (B, 200, {cfg.vocab}) f32 logits of 65536 rows are 194 GB)")
    plan = build_step(arch, dataclasses.replace(
        train_cell, dims={"batch": B4R_TRAIN_ROWS}))
    out.update(train_steps(plan, model, [
        on_dev(items(B4R_TRAIN_ROWS, 20 + i))
        for i in range(RECSYS_TRAIN_STEPS)]))
    out["rows"], out["optimizer"] = B4R_TRAIN_ROWS, arch.optimizer
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["bert4rec"] = out

    # the fault-tolerant loop: one injected fault, one recovery, a resume
    opt = plan.optimizer
    params = model.tree()
    step = make_train_step(lambda p, bt: bert4rec.loss_fn(cfg, p, bt), opt)

    def batches(i):
        return on_dev(items(256, 100 + i))

    reg = obs.registry()
    before = {k: reg.counter(k).value for k in ("train.failures",
                                                "train.recoveries")}
    with tempfile.TemporaryDirectory() as tmp:
        first = run(step, params, opt.init(params), batches,
                    TrainLoopConfig(total_steps=6, checkpoint_every=2,
                                    checkpoint_dir=tmp),
                    injector=FaultInjector(fail_at_steps=(3,)))
        seen = []
        second = run(step, params, opt.init(params), batches,
                     TrainLoopConfig(total_steps=8, checkpoint_every=2,
                                     checkpoint_dir=tmp),
                     on_step=lambda s, l: seen.append(s))
    loop = {"restarts": first.restarts, "final_step": first.final_step,
            "losses": first.losses, "resumed_at": seen[0] if seen else None,
            "second_final": second.final_step,
            "failures": reg.counter("train.failures").value
            - before["train.failures"],
            "recoveries": reg.counter("train.recoveries").value
            - before["train.recoveries"],
            "last_failure_step": reg.gauge("train.last_failure_step").value}
    check(loop["restarts"] == 1 and loop["recoveries"] == 1
          and loop["failures"] == 1 and loop["final_step"] == 6,
          f"one fault, one recovery: {loop}")
    check(seen == [6, 7] and second.final_step == 8,
          f"the second run resumes at step 6: {seen}")
    res["loop"] = loop
    del model, plan, params
    torch.cuda.synchronize()
    return res


# -- the MoE and MLA LMs (Qwen3-30B-A3B, DeepSeek-V2) -----------------------

# layers kept of each full-width model on one 80 GB card: f32 master
# weights and their bf16 compute copy cost 6 bytes a parameter
MOE_LM_DEPTH = {"qwen3_moe_30b_a3b": 8, "deepseek_v2_236b": 2}
MOE_LM_SHAPE = (4, 2048, 2080, 16)   # prompts, prompt tokens, max_len, steps
MLA_BWD_SHAPE = (1, 128, 2048, 192, 128)   # B, H, S, q·k width, v width
# kernels 8 and 8b as they ran at MLA's 192 / 128 heads before their own
# tiles: patched copies of the sources (``_build.build_variants``), timed
# in phase 25 beside the shipped tiles in the same call and never on a
# model's path — the forward with d padded to 256 (the <256, 128> tile),
# the backward's bf16 "simt" route
PREVIOUS_MLA_DESIGN = {
    "forward <256, 128>": ("flash_attention", [(
        "  if (a.d <= 192) return launch_mma_dv<192>(a, batch, stream);\n",
        "")]),
    "backward \"simt\"": ("flash_attention_bwd", [(
        "  if (route == 1) return launch_mma_all(a, batch, st);",
        "  if (route == 1 && d <= 128 && dv_dim <= 128)\n"
        "    return launch_mma_all(a, batch, st);")]),
}
# phase 25: 8b at MLA width holds the bf16 reading of the d = 64 "mma"
# route (3.52e-3 of the largest |grad|, PERF.md) beside BWD_TOL's limit
MLA_BWD_REL_READING = 3.52e-3
ROUTER_SHAPES = {"qwen3_moe_30b_a3b": (8192, 128, 8),   # tokens, E, top-k
                 "deepseek_v2_236b": (8192, 160, 6)}


def recording_router(tx, calls):
    """``tx.router_topk`` replaced by a wrapper that appends each call's
    (T, k) expert ids to ``calls``; returns the original to restore."""
    orig = tx.router_topk

    def router(probs, k, *, use_kernel=True):
        vals, ids = orig(probs, k, use_kernel=use_kernel)
        calls.append(ids)
        return vals, ids
    tx.router_topk = router
    return orig


def replaying_router(tx, calls):
    """``tx.router_topk`` replaced by one that hands back, call by call,
    the expert ids of ``calls`` (another run's) with the gates gathered at
    them, so that a run takes that run's routing; returns the original to
    restore."""
    orig = tx.router_topk
    replay = iter(calls)

    def router(probs, k, *, use_kernel=True):
        ids = next(replay)
        return torch.gather(probs, 1, ids.long()), ids
    tx.router_topk = router
    return orig


def serve_moe_lm(name, dev):
    """One MoE LM of phase 25 at full width, depth cut to
    ``MOE_LM_DEPTH[name]``, weights from a seeded generator on the card:
    ``build_step`` prefill on ``MOE_LM_SHAPE``'s prompts (``lm_batch``
    seed 0) and greedy decode steps with the launch counts zeroed before
    and read after; the first MoE layer on the prefill's own input with
    the kernel selection against the plain one, bit for bit; kernel 8 at
    layer 0's q / k / v against its plain version; the same model on the
    plain attention, teacher-forced, once with its own selection (a
    near-tied gate flips between the runs and the flip cascades: the
    rerouted (token, layer) pairs are counted, and a row whose argmax
    differs at a top-2 margin > 0.05 must have had its own token
    rerouted) and once with the routing pinned to the kernel run's ids
    (argmax equal on every row with a margin > 0.05); a profile of one
    prefill and one decode step."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.batches import lm_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.select import select_topm
    from repro_torch.launch.steps import build_step
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tx

    full = get_arch(name)
    cfg = dataclasses.replace(full.config, n_layers=MOE_LM_DEPTH[name])
    arch = dataclasses.replace(full, config=cfg)
    n_dense, n_moe = cfg.layer_counts()
    b, s, max_len, steps = MOE_LM_SHAPE
    prefill = build_step(arch, dataclasses.replace(
        arch.cell("prefill_32k"), name=f"prefill_{s}",
        dims={"batch": b, "seq": s}))
    decode = build_step(arch, dataclasses.replace(
        arch.cell("decode_32k"), name=f"decode_{max_len}",
        dims={"batch": b, "seq": max_len}))
    out = {"reduced": [f"n_layers {full.config.n_layers} -> {cfg.n_layers} "
                       f"({n_dense} dense + {n_moe} MoE)",
                       f"prefill_32k / decode_32k -> {b} prompts x {s}, "
                       f"max_len {max_len}, {steps} decode steps"],
           "full_params": full.config.param_count(),
           "active_params": cfg.active_param_count()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = tx.Transformer(cfg, tx.init_params(cfg, gen))
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params"] = cm.count_params(model)
    check(out["params"] == cfg.param_count(), f"{name}: parameter count")
    out["weights_gib"] = torch.cuda.memory_allocated() / 2**30
    toks = torch.from_numpy(lm_batch(b, s, cfg.vocab, seed=0)["tokens"]
                            ).to(dev)
    warm, wc = prefill.fn(model, {"tokens": toks[:, :64]}, max_len=80)
    decode.fn(model, {"tokens": warm.argmax(-1, keepdim=True).int(),
                      "cache": wc})
    del warm, wc
    torch.cuda.synchronize()

    zero_counts()
    routes = flash_attention.routes
    routes.update(dict.fromkeys(routes, 0))
    kern_calls, plain_calls = [], []
    orig = recording_router(tx, kern_calls)
    try:
        t0 = time.perf_counter()
        logits, cache = prefill.fn(model, {"tokens": toks}, max_len=max_len)
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t0
        pre = {"flash": flash_attention.launches, "routes": dict(routes),
               "select": select_topm.launches}
        kern_logits, fed = [logits.clone()], []
        t0 = time.perf_counter()
        for _ in range(steps):
            nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
            fed.append(nxt)
            logits, cache = decode.fn(model, {"tokens": nxt, "cache": cache})
            kern_logits.append(logits.clone())
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    finally:
        tx.router_topk = orig
    dec_routes = {k: routes[k] - pre["routes"][k] for k in routes}
    out["launches"] = {
        "flash prefill": pre["flash"],
        "flash decode": flash_attention.launches - pre["flash"],
        "select prefill": pre["select"],
        "select decode": select_topm.launches - pre["select"]}
    out["routes"] = {"prefill": pre["routes"], "decode": dec_routes}
    ln = out["launches"]
    check(ln["flash prefill"] == cfg.n_layers
          and pre["routes"]["mma"] == cfg.n_layers,
          f"{name}: one prefill launch a layer, all on \"mma\": "
          f"{out['launches']}, {pre['routes']}")
    if cfg.mla is None:
        check(ln["flash decode"] == cfg.n_layers * steps
              and dec_routes["split"] == ln["flash decode"],
              f"{name}: one decode launch a layer and step, all on "
              f"\"split\": {out['routes']}")
    else:
        check(ln["flash decode"] == 0,
              f"{name}: the absorbed MLA decode runs no attention kernel")
    check(ln["select prefill"] == n_moe
          and ln["select decode"] == n_moe * steps,
          f"{name}: kernel 5 once a MoE layer and call: {ln}")
    out["decode_ms_per_step"] = decode_s / steps * 1e3
    out["tokens_per_s"] = b * steps / decode_s
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    check(cache["len"].tolist() == [s + steps] * b,
          f"{name}: cache len {cache['len'].tolist()} == {s + steps}")
    check(sorted(cache) == sorted(decode.example_args["cache"]),
          f"{name}: cache keys {sorted(cache)}")
    for lg in kern_logits:
        check(tuple(lg.shape) == (b, cfg.vocab)
              and bool(torch.isfinite(lg).all()),
              f"{name}: finite logits (B, V)")

    # the first MoE layer on this prefill's own input: the FFN with the
    # kernel selection == the FFN with the plain selection, bit for bit;
    # kernel 8 at layer 0's q / k / v against its plain version
    with torch.inference_mode():
        pos = torch.arange(s, device=dev)[None].expand(b, s)
        x = model._embed[toks.long()]
        h0 = cm.rmsnorm(model._layers[0]["ln1"], x)
        if cfg.mla is not None:
            q, k, v, _ = tx._mla_qkv(cfg, model._layers[0]["attn"], h0, pos)
            scale = 1.0 / cfg.mla.qk_dim ** 0.5
        else:
            q, k, v = tx._gqa_qkv(cfg, model._layers[0]["attn"], h0, pos)
            scale = None
        out["layer0_err"] = flash_close(
            f"{name}: flash at layer 0 of the prefill",
            flash_attention(q, k, v, scale=scale), q, k, v, causal=True,
            scale=scale)
        out["qkv"] = (q, k, v, scale)
        for i in range(n_dense):
            x, _ = tx._layer_fwd(cfg, "dense", model._layers[i], x, pos,
                                 True)
        p = model._layers[n_dense]
        attn = tx._mla_attention if cfg.mla is not None \
            else tx._gqa_attention
        x = x + attn(cfg, p["attn"], cm.rmsnorm(p["ln1"], x), pos, True)[0]
        ffn_in = cm.rmsnorm(p["ln2"], x)
        before = select_topm.launches
        y_kernel = tx._moe_ffn(cfg, p["ffn"], ffn_in, use_kernel=True)
        check(select_topm.launches == before + 1,
              f"{name}: the MoE check ran kernel 5")
        y_plain = tx._moe_ffn(cfg, p["ffn"], ffn_in, use_kernel=False)
        check(torch.equal(y_kernel, y_plain),
              f"{name}: MoE layer {n_dense} with kernel 5 == with the plain "
              f"selection, bit for bit")
        del x, h0, ffn_in, y_kernel, y_plain

    # the same model on the plain attention, teacher-forced on the fed
    # tokens: once with its own (plain) selection, once with the routing
    # pinned to the kernel run's expert ids
    def plain_run(restore):
        """Prefill and the decode steps on the plain attention, under the
        router installed by the caller; ``restore`` is put back after."""
        model.use_kernel = False
        try:
            with torch.inference_mode():
                plain, pc = prefill.fn(model, {"tokens": toks},
                                       max_len=max_len)
                res = []
                for step in range(steps + 1):
                    if step:
                        plain, pc = decode.fn(model, {
                            "tokens": fed[step - 1], "cache": pc})
                    res.append(plain)
        finally:
            tx.router_topk = restore
            model.use_kernel = True
        check(pc["len"].tolist() == [s + steps] * b,
              f"{name}: plain cache len")
        return res

    plain_free = plain_run(recording_router(tx, plain_calls))
    check(len(kern_calls) == len(plain_calls),
          f"{name}: router calls {len(kern_calls)} vs {len(plain_calls)}")
    flips = [(a.sort(1).values != c.sort(1).values).any(1)
             for a, c in zip(kern_calls, plain_calls)]
    out["routing_diff"] = (sum(int(f.sum()) for f in flips),
                           sum(f.numel() for f in flips))
    # per logits row: did its own token route differently in any MoE
    # layer (the prompt's last token at step 0, the fed token after)
    own = [torch.stack([flips[li][torch.arange(b, device=dev) * s + s - 1]
                        for li in range(n_moe)]).any(0)]
    own += [torch.stack([flips[n_moe * t + li] for li in range(n_moe)]
                        ).any(0) for t in range(1, steps + 1)]
    free = {"diffs": [], "checked": 0, "agree": 0, "rows": []}
    for step, (kl, pl) in enumerate(zip(kern_logits, plain_free)):
        free["diffs"].append(max_diff(kl, pl))
        top = pl.max(-1)
        rest = pl.scatter(-1, top.indices[:, None], float("-inf")).max(-1)
        margin = top.values - rest.values
        n, a = lm_margin_agree(kl, pl)
        free["checked"] += n
        free["agree"] += a
        for row in range(b):
            if margin[row] > 0.05 and kl[row].argmax() != top.indices[row]:
                free["rows"].append((step, row, float(margin[row]),
                                     bool(own[step][row])))
    out["free"] = free
    check(all(row[3] for row in free["rows"]),
          f"{name}: with free routing, every row whose argmax differs at a "
          f"top-2 margin > 0.05 had its own token rerouted: {free['rows']}")
    del plain_free

    plain_pinned = plain_run(replaying_router(tx, kern_calls))
    diffs, checked, agree = [], 0, 0
    for kl, pl in zip(kern_logits, plain_pinned):
        diffs.append(max_diff(kl, pl))
        n, a = lm_margin_agree(kl, pl)
        checked, agree = checked + n, agree + a
    out["max_logit_diff"] = max(diffs)
    out["logit_diffs"] = diffs
    out["argmax"] = (agree, checked)
    check(agree == checked, f"{name}: with the routing pinned, argmax "
                            f"agrees on rows with margin > 0.05: {agree} "
                            f"of {checked}")
    check(checked > 0, f"{name}: some rows have a top-2 margin above 0.05")
    del kern_calls, plain_calls, plain_pinned, kern_logits, flips

    state = {"cache": cache}

    def one_prefill():
        prefill.fn(model, {"tokens": toks}, max_len=max_len)

    def one_decode():
        state["cache"] = decode.fn(model, {"tokens": toks[:, -1:].contiguous(),
                                           "cache": state["cache"]})[1]
    out["profile"] = profile_each(((f"{name} prefill ({b} x {s})",
                                    one_prefill, 8),
                                   (f"{name} decode step ({b} rows)",
                                    one_decode, 8)))
    del model, cache, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_train_steps(dev):
    """One ``build_step`` train step (AdamW) of each MoE smoke config on
    the card, in f32: the forward and backward kernels on their f32
    "simt" routes, kernel 5 once a MoE layer; a finite loss."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.batches import lm_batch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.select import select_topm
    from repro_torch.launch.steps import build_step
    from repro_torch.models import transformer as tx

    out = {}
    for name in MOE_LM_DEPTH:
        arch = get_arch(name)
        cfg = arch.smoke_config()
        arch = dataclasses.replace(arch, config=cfg)
        plan = build_step(arch, dataclasses.replace(
            arch.cell("train_4k"), dims={"batch": 4, "seq": 64}))
        gen = torch.Generator(device=dev).manual_seed(0)
        model = tx.Transformer(cfg, tx.init_params(cfg, gen))
        opt_state = plan.optimizer.init(model.tree())
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 lm_batch(4, 64, cfg.vocab, seed=0).items()}
        zero_counts()
        t0 = time.perf_counter()
        model, opt_state, loss = plan.fn(model, opt_state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash": flash_attention.launches,
                    "flash_bwd": flash_attention_bwd.launches,
                    "bwd routes": dict(flash_attention_bwd.routes),
                    "select": select_topm.launches}
        check(math.isfinite(float(loss)), f"{name} smoke: finite loss")
        check(launches["flash"] == launches["flash_bwd"] == cfg.n_layers
              and launches["bwd routes"]["simt"] == cfg.n_layers
              and launches["select"] == cfg.layer_counts()[1],
              f"{name} smoke train step launches {launches}")
        out[name] = {"loss": float(loss), "wall_s": wall,
                     "launches": launches}
        del model, opt_state
    return out


def in_turns(new, old, reps):
    """``time_ms`` of ``new`` and ``old`` in the order old, new, new, old:
    (new's mean, old's mean, the four readings in that order)."""
    t = [time_ms(fn, reps=reps) for fn in (old, new, new, old)]
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, t


def moe_kernel_timings(dev, ds, qw, previous):
    """Phase 25's kernel rows and readings: kernel 8 at DeepSeek-V2's MLA
    prefill launch (layer 0's q / k / v: 4 × 128 heads × 2048, q·k 192, v
    128, bf16, causal, route "mma" on its <192, 128> tile) beside the
    <256, 128> tile it ran on before (``previous``: the paths of
    ``PREVIOUS_MLA_DESIGN``'s builds, timed in turns with it),
    ``scaled_dot_product_attention`` and its bound (2·(192 + 128)
    operations a visible pair at the bf16 peak; q, k, v read and the
    output written once); kernel 5 at both router shapes beside
    ``torch.topk``; kernel 8b at ``MLA_BWD_SHAPE`` on "mma" against its
    plain version, beside the "simt" route it took before (in turns), and
    SDPA's backward."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain, mma_tile)
    from repro_torch.kernels.select import select_topm, select_topm_twin

    q, k, v, scale = ds.pop("qkv")
    b, h, s, d = q.shape
    dv = v.shape[3]
    tile = mma_tile(d, dv)
    check(tile == "192x128", f"MLA's heads take the <192, 128> tile: {tile}")

    def padded():
        with _build.swapped("flash_attention",
                            previous["forward <256, 128>"]):
            return flash_attention(q, k, v, scale=scale)

    with torch.inference_mode():
        before = flash_attention.tiles.get(tile, 0)
        flash_attention(q, k, v, scale=scale)
        check(flash_attention.tiles.get(tile, 0) == before + 1,
              f"the MLA prefill launch ran the {tile} tile")
        prev_err = flash_close("flash at layer 0 on the <256, 128> tile",
                               padded(), q, k, v, causal=True, scale=scale)
        ms, prev_ms, fwd_turns = in_turns(
            lambda: flash_attention(q, k, v, scale=scale), padded, reps=10)
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v,
                                                         scale=scale), reps=2)
        library = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale), reps=10)
    check(ms <= prev_ms, f"the <192, 128> tile ({ms} ms) no slower than the "
                         f"<256, 128> one ({prev_ms} ms) in the same call")
    pairs = b * h * s * (s + 1) / 2
    bound, by = bound_ms(2.0 * b * h * s * (2 * d + 2 * dv),
                         2.0 * (d + dv) * pairs, PEAK_BF16_OPS_PER_S)
    mla_row = {"name": "flash_attention:mla_prefill", "route": "cuda",
               "source": "src/repro_torch/csrc/flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention.py:84",
               "launches": ds["launches"]["flash prefill"],
               "max_abs_err": ds["layer0_err"], "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
               "library_ms": library, "previous_ms": prev_ms,
               "previous_err": prev_err, "turns": fwd_turns,
               "shape": f"MLA prefill B={b} H={h} S={s} d={d} dv={dv} bf16 "
                        f"causal (route mma, tile {tile})"}
    del q, k, v

    gen = torch.Generator(device=dev).manual_seed(25)
    router = {}
    for name, (t, e, m) in ROUTER_SHAPES.items():
        probs = torch.softmax(torch.randn((t, e), generator=gen,
                                          device=dev), -1)
        q_ids = torch.full((t,), -1, dtype=torch.int32, device=dev)
        got = select_topm(probs, q_ids, m=m)
        want = select_topm_twin(probs, q_ids, m=m)
        check(torch.equal(got[1], want[1]), f"router select {name}: ids")
        err = max_diff(got[0], want[0])
        check(err == 0.0, f"router select {name}: values diff {err}")
        rb, rby = bound_ms(t * e * 4.0 + t * m * 8.0, float(t * e),
                           PEAK_F32_OPS_PER_S)
        router[name] = {
            "shape": f"T={t} E={e} m={m}", "max_abs_err": err,
            "ms": time_ms_queued(lambda: select_topm(probs, q_ids, m=m)),
            "plain_ms": time_ms(lambda: select_topm_twin(probs, q_ids, m=m),
                                reps=10),
            "library_ms": time_ms_queued(lambda: torch.topk(probs, m)),
            "bound_ms": rb, "bound_by": rby}
    first = router["qwen3_moe_30b_a3b"]
    router_row = {"name": "select_topm:router", "route": "cuda",
                  "source": "src/repro_torch/csrc/select.cu",
                  "replaces": "src/repro/kernels/select.py:164",
                  "launches": sum(o["launches"]["select prefill"]
                                  + o["launches"]["select decode"]
                                  for o in (qw, ds)),
                  "max_abs_err": max(r["max_abs_err"]
                                     for r in router.values()),
                  **{key: first[key] for key in ("ms", "plain_ms",
                                                 "library_ms", "bound_ms",
                                                 "bound_by", "shape")}}

    b, h, s, d, dv = MLA_BWD_SHAPE
    q, k = (torch.randn((b, h, s, d), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    v = torch.randn((b, h, s, dv), generator=gen, device=dev).to(
        torch.bfloat16)
    err, rel, o, do, lse = bwd_close("flash bwd bf16 at MLA width", q, k, v,
                                     "mma")

    def simt():
        with _build.swapped("flash_attention_bwd",
                            previous["backward \"simt\""]):
            return flash_attention_bwd(q, k, v, o, do, lse)

    want = flash_attention_bwd_plain(*(t.float() for t in (q, k, v, o, do)))
    prev_rel = max(max_diff(g, w) / max(1.0, float(w.abs().max()))
                   for g, w in zip(simt(), want))
    del want
    bwd_ms, bwd_prev, bwd_turns = in_turns(
        lambda: flash_attention_bwd(q, k, v, o, do, lse), simt, reps=3)
    bwd = {"name": "flash_attention_bwd:mla", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
           "replaces": "src/repro/models/common.py:126", "launches": 0,
           "shape": f"B={b} H={h} S={s} d={d} dv={dv} bf16 causal (route "
                    f"mma)",
           "max_abs_err": err, "rel_err": rel, "ms": bwd_ms,
           "previous_ms": bwd_prev, "previous_rel": prev_rel,
           "turns": bwd_turns,
           "plain_ms": time_ms(lambda: flash_attention_bwd_plain(
               q, k, v, o, do), reps=1)}
    check(bwd["ms"] < bwd["plain_ms"],
          f"8b at MLA width on \"mma\" ({bwd['ms']} ms) faster than its "
          f"plain version ({bwd['plain_ms']} ms)")
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    bwd["library_ms"] = time_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), do, retain_graph=True), reps=3)
    pairs = b * h * s * (s + 1) / 2
    bwd["bound_ms"], bwd["bound_by"] = bound_ms(
        2.0 * b * h * s * (4 * d + 4 * dv),
        2.0 * (3 * d + 2 * dv) * pairs, PEAK_BF16_OPS_PER_S)
    del q, k, v, o, do, lse, ql, kl, vl, lib_out
    torch.cuda.synchronize()
    return mla_row, router_row, router, bwd


def phase_moe_mla(dev, previous):
    """Phase 25: Qwen3-30B-A3B and DeepSeek-V2 served at full width (one
    after the other, each freed before the next), one train step of each
    smoke config, and the kernel rows of kernels 8 and 8b at MLA's widths
    (beside ``previous``, the paths of ``PREVIOUS_MLA_DESIGN``'s builds)
    and kernel 5 at the router shapes."""
    out = {"qwen3_moe_30b_a3b": serve_moe_lm("qwen3_moe_30b_a3b", dev)}
    out["qwen3_moe_30b_a3b"].pop("qkv")
    out["deepseek_v2_236b"] = serve_moe_lm("deepseek_v2_236b", dev)
    out["train"] = moe_train_steps(dev)
    out["rows"] = moe_kernel_timings(dev, out["deepseek_v2_236b"],
                                     out["qwen3_moe_30b_a3b"], previous)
    return out


# -- the model-parallel train step on a one-rank NCCL mesh ----------------

MESH_MOE_SHAPE = (4, 2048)      # phase 26 (b): the MoE forward's batch


def mesh_step_pair(arch, cell, mesh, model, batches, place, profile=None):
    """``build_step(arch, cell)`` and ``build_step(arch, cell, mesh)`` from
    the same weights (``model``; ``place`` makes the meshed copy before
    any step) over ``batches``, one after the other: each plan's losses,
    step walls, peak GiB and launch counts (zeroed before its run and
    read after), and both updated parameter trees; with ``profile`` (a
    name), each plan's step on the first batch under the profiler after
    the timed steps."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.select import select_topm
    from repro_torch.launch.steps import build_step, place_model

    plans = {"plain": build_step(arch, cell),
             "mesh": build_step(arch, cell, mesh)}
    models = {"mesh": place_model(model, plans["mesh"].in_shardings[0])
              if place else None, "plain": model}
    out = {}
    for key in ("plain", "mesh"):
        plan, m = plans[key], models[key]
        state = plan.optimizer.init(m.tree())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        losses, walls = [], []
        for batch in batches:
            t0 = time.perf_counter()
            m, state, loss = plan.fn(m, state, batch)
            losses.append(float(loss))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[key] = {"losses": losses, "walls": walls,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "launches": {"flash": flash_attention.launches,
                                 "flash_bwd": flash_attention_bwd.launches,
                                 "select": select_topm.launches},
                    "model": m}
        if profile:
            out[key]["profile"] = profile_each(((
                f"{profile} {key} step", lambda: plan.fn(m, state,
                                                         batches[0])),))[0]
        del state
        gc.collect()
        torch.cuda.empty_cache()
    return out


def full_leaves(model):
    """The model's parameters as whole tensors (DTensors gathered), in
    tree order."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.checkpoint import tree_flatten
    return [(p.full_tensor() if isinstance(p, DTensor) else p).detach()
            for p in tree_flatten(model.tree())]


def phase_mesh_train(dev):
    """Phase 26: the model-parallel train step on a one-rank NCCL mesh
    (axes ("data", "model"), shape (1, 1)), each piece against its
    no-mesh twin on the same weights and batch.  (a) Llama-3.2-1B at
    phase 23's shape: one gradient through ``transformer.backward`` under
    ``make_ctx`` against the no-mesh one (loss 1e-3 relative, each leaf's
    ‖Δg‖/‖g‖ ≤ 1e-2, bitwise printed), then one ``build_step`` train step
    each (walls, peaks, kernel 8 / 8b launches equal).  (b) Qwen3-30B-A3B
    and DeepSeek-V2 at phase 25's depths: the loss of one batch through
    the sharded MoE branch against the unsharded one, forward only, the
    expert ids equal on every (token, layer).  (c) both MoE smoke configs:
    two AdamW steps, mesh within 1e-5 of no mesh.  (d, e) DLRM (fields
    capped at ``DLRM_TRAIN_ROW_CAP``), FM, xDeepFM and BERT4Rec at phase
    24's sizes: ``RECSYS_TRAIN_STEPS`` steps, losses within 1e-5
    relative.  (f) DLRM serve_p99 through the mesh step == the no-mesh
    forward."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.batches import (bert4rec_batch, lm_batch,
                                          recsys_batch)
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.select import select_topm
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import (_local_leaves, _lm_rows,
                                          build_step, place_model)
    from repro_torch.models import bert4rec, dlrm, fm, xdeepfm
    from repro_torch.models import transformer as tx
    from repro_torch.training.train_loop import take_grads, trainable

    mesh = make_local_mesh((1, 1), ("data", "model"), device=dev)
    res = {"mesh": f"{mesh.device_type} mesh {tuple(mesh.shape)} over "
                   f"{mesh.mesh_dim_names}"}
    check(mesh.device_type == "cuda", f"an NCCL mesh: {res['mesh']}")

    def on_dev(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    # (a) Llama-3.2-1B: one gradient each way, then one step each way
    b, s = LM_TRAIN_SHAPE
    arch = get_arch("llama3_2_1b")
    cfg = dataclasses.replace(arch.config, microbatch=LM_TRAIN_MICROBATCH,
                              remat=True)
    arch = dataclasses.replace(arch, config=cfg)
    cell = dataclasses.replace(arch.cell("train_4k"), name=f"train_4k_b{b}",
                               dims={"batch": b, "seq": s})
    gen = torch.Generator(device=dev).manual_seed(0)
    model = tx.Transformer(cfg, tx.init_params(cfg, gen))
    batch = on_dev(lm_batch(b, s, cfg.vocab, seed=0))
    sc = shd.make_ctx(mesh)
    tree = trainable(model.tree())
    zero_counts()
    plain_loss = float(tx.backward(cfg, tree, batch))
    plain_grads = take_grads(tree)
    plain_n = (flash_attention.launches, flash_attention_bwd.launches)
    placed = place_model(model, shd.to_shardings(mesh, tx.param_specs(cfg)))
    local = _local_leaves(placed.tree())
    zero_counts()
    mesh_loss = float(tx.backward(cfg, local, _lm_rows(
        batch, mesh, shd.batch_axes(mesh), cfg.microbatch, dev), sc=sc))
    mesh_n = (flash_attention.launches, flash_attention_bwd.launches)
    mesh_grads = take_grads(local)
    rel = grad_readings(mesh_grads, plain_grads)
    from repro_torch.distributed.checkpoint import tree_flatten
    bitwise = all(torch.equal(a, c) for a, c in zip(
        tree_flatten(mesh_grads), tree_flatten(plain_grads)))
    del plain_grads, mesh_grads, local, placed, tree
    a = {"loss": (mesh_loss, plain_loss),
         "loss_rel": abs(mesh_loss - plain_loss) / abs(plain_loss),
         "grad_rel": rel, "bitwise": bitwise and mesh_loss == plain_loss,
         "grad_launches": {"mesh": mesh_n, "plain": plain_n}}
    check(math.isfinite(mesh_loss) and a["loss_rel"] <= 1e-3,
          f"Llama mesh loss {mesh_loss} vs {plain_loss}")
    check(max(rel) <= 1e-2, f"Llama mesh per-leaf ‖Δg‖/‖g‖ {rel} ≤ 1e-2")
    check(mesh_n == plain_n and mesh_n[1] > 0,
          f"Llama gradient launches mesh {mesh_n} == plain {plain_n}")
    pair = mesh_step_pair(arch, cell, mesh, model, [batch], place=True)
    for key in ("plain", "mesh"):
        a[f"{key}_step"] = {k: v for k, v in pair[key].items()
                            if k != "model"}
    check(pair["mesh"]["launches"] == pair["plain"]["launches"]
          and pair["mesh"]["launches"]["flash_bwd"] > 0,
          f"Llama step launches {a['mesh_step']['launches']} == "
          f"{a['plain_step']['launches']}")
    step_rel = abs(pair["mesh"]["losses"][0] - pair["plain"]["losses"][0]) \
        / abs(pair["plain"]["losses"][0])
    check(step_rel <= 1e-3, f"Llama step losses {pair['mesh']['losses']} vs "
          f"{pair['plain']['losses']}")
    res["llama"] = a
    del model, pair, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the MoE LMs at phase 25's depths: the loss, forward only
    b, s = MESH_MOE_SHAPE
    res["moe"] = {}
    for name, depth in MOE_LM_DEPTH.items():
        cfg = dataclasses.replace(get_arch(name).config, n_layers=depth)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = tx.init_params(cfg, gen)
        batch = on_dev(lm_batch(b, s, cfg.vocab, seed=0))
        got = {}
        for key, ctx in (("plain", tx.NO_SHARDING), ("mesh", sc)):
            calls = []
            orig = recording_router(tx, calls)
            zero_counts()
            try:
                with torch.no_grad():
                    t0 = time.perf_counter()
                    loss = float(tx.loss_fn(cfg, params, batch, sc=ctx))
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            finally:
                tx.router_topk = orig
            got[key] = {"loss": loss, "ids": calls, "wall_s": wall,
                        "launches": {"flash": flash_attention.launches,
                                     "select": select_topm.launches}}
        same_ids = len(got["mesh"]["ids"]) == len(got["plain"]["ids"]) \
            and all(torch.equal(x, y) for x, y in zip(got["mesh"]["ids"],
                                                       got["plain"]["ids"]))
        o = {"loss": (got["mesh"]["loss"], got["plain"]["loss"]),
             "loss_rel": abs(got["mesh"]["loss"] - got["plain"]["loss"])
             / abs(got["plain"]["loss"]),
             "bitwise": got["mesh"]["loss"] == got["plain"]["loss"],
             "ids_equal": same_ids,
             "pairs": sum(int(x.shape[0]) for x in got["mesh"]["ids"]),
             "launches": {k: v["launches"] for k, v in got.items()},
             "walls": {k: v["wall_s"] for k, v in got.items()},
             "reduced": f"n_layers {get_arch(name).config.n_layers} -> "
                        f"{depth}; train_4k -> {b} x {s}, forward only"}
        check(same_ids, f"{name}: expert ids equal on every (token, layer)")
        check(math.isfinite(o["loss"][0]) and o["loss_rel"] <= 1e-3,
              f"{name}: sharded-branch loss {o['loss']}")
        check(o["launches"]["mesh"] == o["launches"]["plain"]
              and o["launches"]["mesh"]["select"]
              == cfg.layer_counts()[1] > 0,
              f"{name}: launches {o['launches']}")
        res["moe"][name] = o
        del params, batch, got
        gc.collect()
        torch.cuda.empty_cache()

    # (c) the MoE smoke configs: two AdamW steps each way
    res["moe_smoke"] = {}
    for name in MOE_LM_DEPTH:
        arch = get_arch(name)
        cfg = arch.smoke_config()
        arch = dataclasses.replace(arch, config=cfg)
        cell = dataclasses.replace(arch.cell("train_4k"),
                                   dims={"batch": 4, "seq": 64})
        gen = torch.Generator(device=dev).manual_seed(0)
        model = tx.Transformer(cfg, tx.init_params(cfg, gen))
        batches = [on_dev(lm_batch(4, 64, cfg.vocab, seed=i))
                   for i in range(2)]
        pair = mesh_step_pair(arch, cell, mesh, model, batches, place=True)
        err = max(max_diff(x, y) for x, y in zip(
            full_leaves(pair["mesh"]["model"]),
            full_leaves(pair["plain"]["model"])))
        lrel = max(abs(x - y) / abs(y) for x, y in zip(
            pair["mesh"]["losses"], pair["plain"]["losses"]))
        res["moe_smoke"][name] = {
            "losses": (pair["mesh"]["losses"], pair["plain"]["losses"]),
            "param_err": err, "loss_rel": lrel,
            "launches": pair["mesh"]["launches"]}
        check(err <= 1e-5 and lrel <= 1e-5,
              f"{name} smoke: mesh vs no mesh params {err}, losses {lrel}")
        check(pair["mesh"]["launches"] == pair["plain"]["launches"],
              f"{name} smoke launches {pair['mesh']['launches']} vs "
              f"{pair['plain']['launches']}")
        del model, pair

    # (d, e) the recsys models at phase 24's sizes; (f) DLRM serve_p99
    res["recsys"] = {}
    for name, mod, cls in (("dlrm_mlperf", dlrm, dlrm.DLRM),
                           ("fm", fm, fm.FM),
                           ("xdeepfm", xdeepfm, xdeepfm.XDeepFM),
                           ("bert4rec", bert4rec, bert4rec.BERT4Rec)):
        arch = get_arch(name)
        cfg = arch.config
        if name == "dlrm_mlperf":
            cfg = dataclasses.replace(cfg, field_sizes=tuple(
                min(f, DLRM_TRAIN_ROW_CAP) for f in cfg.field_sizes))
            arch = dataclasses.replace(arch, config=cfg)
        cell = arch.cell("train_batch")
        rows = {"xdeepfm": XDEEPFM_TRAIN_ROWS,
                "bert4rec": B4R_TRAIN_ROWS}.get(name, cell.dims["batch"])
        cell = dataclasses.replace(cell, dims={"batch": rows})
        gen = torch.Generator(device=dev).manual_seed(0)
        model = cls(cfg, mod.init_params(cfg, gen))
        if name == "bert4rec":
            batches = [on_dev(bert4rec_batch(rows, cfg.seq_len, cfg.n_items,
                                             cfg.mask_token, seed=20 + i))
                       for i in range(RECSYS_TRAIN_STEPS)]
        else:
            batches = [on_dev(recsys_batch(rows, cfg.field_sizes,
                                           getattr(cfg, "n_dense", 0),
                                           seed=10 + i))
                       for i in range(RECSYS_TRAIN_STEPS)]
        serve = None
        if name == "dlrm_mlperf":
            sc_cell = arch.cell("serve_p99")
            sb = recsys_inputs(cfg, sc_cell.dims["batch"], 0)
            want = build_step(arch, sc_cell).fn(model, sb)
            placed = place_model(model, build_step(
                arch, sc_cell, mesh).in_shardings[0])
            zero_counts()
            t0 = time.perf_counter()
            got = build_step(arch, sc_cell, mesh).fn(placed, sb)
            torch.cuda.synchronize()
            serve = {"err": max_diff(got.full_tensor(), want),
                     "wall_s": time.perf_counter() - t0,
                     "placements": [repr(p) for p in got.placements]}
            check(serve["err"] == 0.0, f"DLRM serve_p99 mesh vs no mesh: "
                  f"{serve['err']}")
            del placed, got, want
        pair = mesh_step_pair(arch, cell, mesh, model, batches, place=True,
                              profile=name if name in ("dlrm_mlperf", "fm")
                              else None)
        lrel = [abs(x - y) / abs(y) for x, y in zip(
            pair["mesh"]["losses"], pair["plain"]["losses"])]
        o = {"losses": (pair["mesh"]["losses"], pair["plain"]["losses"]),
             "loss_rel": lrel, "rows": rows, "optimizer": arch.optimizer,
             "walls": {k: pair[k]["walls"] for k in ("mesh", "plain")},
             "peak_gib": {k: pair[k]["peak_gib"] for k in ("mesh", "plain")},
             "serve": serve}
        check(all(math.isfinite(x) for x in pair["mesh"]["losses"])
              and max(lrel) <= 1e-5,
              f"{name}: mesh losses {o['losses']} ({lrel} relative)")
        res["recsys"][name] = o
        del model, pair, batches
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return res


# -- LM serving on a one-rank NCCL mesh ------------------------------------

LM_SERVE_SHAPE = (4, 2048, 2080, 16)   # phase 11's prompts, tokens, max_len,
                                        # decode steps
MESH_MOE_STEPS = 8                      # phase 27 (c): decode steps
MERGE_SPLITS = (2, 4)                   # phase 27 (b): sequence slices
MERGE_LENS = (2049, 1100, 520, 7)       # phase 27 (b): each row's kv_len


def mesh_serve_run(pre, dec, model, toks, max_len, steps):
    """One plan pair's serving run: a warm-up prefill of ``toks`` and one
    decode step, its logits gathered (the meshed model makes its compute
    copy there, the allocator its blocks, the mesh its first gather),
    then with every launch count zeroed: ``pre`` on ``toks`` into a cache
    of ``max_len``, timed, and ``steps`` greedy decode steps, timed
    together (the mesh's logits gathered whole each step, as a caller
    sampling from them would); the logits of every call and the tokens
    fed, each MoE call's expert ids, walls, the peak and its growth over
    what was allocated before, and launches."""
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.select import select_topm
    from repro_torch.models import transformer as tx

    def whole(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    warm, wc = pre.fn(model, {"tokens": toks}, max_len=max_len)
    warm = whole(dec.fn(model, {
        "tokens": whole(warm).argmax(-1, keepdim=True).int(),
        "cache": wc})[0])
    del warm, wc
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_counts()
    routes = flash_attention.routes
    routes.update(dict.fromkeys(routes, 0))
    calls = []
    orig = recording_router(tx, calls)
    try:
        t0 = time.perf_counter()
        logits, cache = pre.fn(model, {"tokens": toks}, max_len=max_len)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pre_n = (flash_attention.launches, dict(routes),
                 select_topm.launches)
        out_logits, fed = [whole(logits).clone()], []
        t0 = time.perf_counter()
        for _ in range(steps):
            nxt = out_logits[-1].argmax(-1, keepdim=True).to(torch.int32)
            fed.append(nxt)
            logits, cache = dec.fn(model, {"tokens": nxt, "cache": cache})
            out_logits.append(whole(logits).clone())
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    finally:
        tx.router_topk = orig
    return {"logits": out_logits, "fed": fed, "ids": calls,
            "prefill_s": prefill_s, "decode_ms": decode_s / steps * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "grown_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
            "len": whole(cache["len"]).tolist(),
            "launches": {
                "flash prefill": pre_n[0], "prefill routes": pre_n[1],
                "flash decode": flash_attention.launches - pre_n[0],
                "decode routes": {k: routes[k] - pre_n[1][k]
                                  for k in routes},
                "select": select_topm.launches}}


def mesh_serve_pair(arch, mesh, model, toks, max_len, steps, before=None):
    """``build_step``'s prefill and decode plans without a mesh and on
    ``mesh`` from the same weights (``model`` and its ``place_model``
    copy, both resident; ``before(model, plans)`` runs first, on the
    no-mesh pair), each through :func:`mesh_serve_run` in turns — no
    mesh, mesh, mesh, no mesh — and their comparison: greedy tokens and
    expert ids equal in all four runs, the largest logit difference
    between the first two, bitwise over all four.  ``plain`` and
    ``mesh`` are each plan's first run, with both turns' walls."""
    import dataclasses

    from repro_torch.launch.steps import build_step, place_model

    b, s = toks.shape
    cells = (dataclasses.replace(arch.cell("prefill_32k"),
                                 name=f"prefill_{s}",
                                 dims={"batch": b, "seq": s}),
             dataclasses.replace(arch.cell("decode_32k"),
                                 name=f"decode_{max_len}",
                                 dims={"batch": b, "seq": max_len}))
    plans = {"plain": [build_step(arch, c) for c in cells],
             "mesh": [build_step(arch, c, mesh) for c in cells]}
    models = {"plain": model,
              "mesh": place_model(model, plans["mesh"][0].in_shardings[0])}
    out = {}
    if before is not None:
        out["before"] = before(model, plans["plain"])
    runs = [(key, mesh_serve_run(*plans[key], models[key], toks, max_len,
                                 steps))
            for key in ("plain", "mesh", "mesh", "plain")]
    del models, model
    first = {key: run for key, run in reversed(runs)}
    p, m = first["plain"], first["mesh"]
    out["tokens_equal"] = all(torch.equal(x, y) for _, r in runs
                              for x, y in zip(p["fed"], r["fed"]))
    out["ids_equal"] = all(len(r["ids"]) == len(p["ids"]) and all(
        torch.equal(x, y) for x, y in zip(p["ids"], r["ids"]))
        for _, r in runs)
    out["pairs"] = sum(int(x.shape[0]) for x in m["ids"])
    out["max_logit_diff"] = max(max_diff(x, y) for x, y in
                                zip(m["logits"], p["logits"]))
    out["bitwise"] = all(torch.equal(x, y) for _, r in runs
                         for x, y in zip(r["logits"], p["logits"]))
    for key in ("plain", "mesh"):
        out[key] = first[key]
        out[key]["turns"] = [(r["prefill_s"], r["decode_ms"])
                             for k, r in runs if k == key]
    for _, r in runs:
        r["logits"] = r["fed"] = r["ids"] = None
    del runs, first, p, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def merge_emulation(model, plans, toks, max_len):
    """Phase 27 (b): one decode step of the no-mesh plans from a prefill
    of ``toks``, with every layer's kernel-8 inputs recorded; then each
    layer's cache split into ``MERGE_SPLITS`` sequence slices, kernel 8
    with ``return_lse`` on each slice (its offset, its own ``kv_len``;
    rows at ``MERGE_LENS``, so that some slices hold no visible key) and
    the slices merged by ``merge_by_lse_parts``, against the unsplit
    kernel: f32 copies within 1e-5; bf16 within one bf16 ulp at the scale
    of the larger of the slices' partial outputs and the result (the
    partials are rounded to bf16 once each, the merge is f32 and rounds
    once), no NaN."""
    from repro_torch.models import common as cm

    pre, dec = plans
    logits, cache = pre.fn(model, {"tokens": toks}, max_len=max_len)
    recorded, orig = [], cm.decode_attention

    def recording(q, k, v, cache_len, **kw):
        recorded.append((q, k, v))
        return orig(q, k, v, cache_len, **kw)
    cm.decode_attention = recording
    try:
        dec.fn(model, {"tokens": logits.argmax(-1, keepdim=True).int(),
                       "cache": cache})
    finally:
        cm.decode_attention = orig
    del logits, cache
    lens = torch.tensor(MERGE_LENS, dtype=torch.int32, device=toks.device)
    res = {"layers": len(recorded), "f32": 0.0, "bf16": 0.0,
           "bf16_ulps": 0.0, "empty_slices": 0, "nan": False}
    for q, k, v in recorded:
        skv = k.shape[2]
        for n in MERGE_SPLITS:
            bounds = [skv * i // n for i in range(n + 1)]
            for dt in (torch.float32, torch.bfloat16):
                qq, kk, vv = (t.to(dt) for t in (q, k, v))
                want = cm.decode_attention(qq, kk, vv, lens)
                outs, lses = [], []
                for lo, hi in zip(bounds, bounds[1:]):
                    o, lse = cm.decode_attention(
                        qq, kk[:, :, lo:hi], vv[:, :, lo:hi], lens,
                        offset=lo, return_lse=True)
                    outs.append(o)
                    lses.append(lse)
                    res["empty_slices"] += int((lens <= lo).sum())
                got = cm.merge_by_lse_parts(outs, lses)
                res["nan"] |= bool(torch.isnan(got).any())
                err = max_diff(got, want)
                if dt == torch.float32:
                    res["f32"] = max(res["f32"], err)
                    continue
                res["bf16"] = max(res["bf16"], err)
                scale = torch.stack([o.float().abs() for o in outs]
                                    + [want.float().abs()]).amax(0)
                ulps = (got.float() - want.float()).abs() \
                    / (BF16_ULP * scale).clamp_min(1e-30)
                ulps = torch.where(got == want, torch.zeros_like(ulps), ulps)
                res["bf16_ulps"] = max(res["bf16_ulps"], float(ulps.max()))
    check(res["layers"] == model.cfg.n_layers,
          f"merge: one decode input a layer ({res['layers']})")
    check(not res["nan"], "merge: no NaN")
    check(res["empty_slices"] > 0, "merge: some slices hold no visible key")
    check(res["f32"] <= 1e-5, f"merge f32 vs unsplit {res['f32']} > 1e-5")
    check(res["bf16_ulps"] <= 1.0,
          f"merge bf16 vs unsplit {res['bf16_ulps']} bf16 ulps > 1")
    return res


def phase_mesh_serve(dev):
    """Phase 27: LM serving on a one-rank NCCL mesh (axes ("data",
    "model"), shape (1, 1)), each model's meshed ``build_step`` prefill
    and decode plans against the no-mesh plans from the same weights
    (:func:`mesh_serve_pair`).  (a) Llama-3.2-1B at phase 11's shape:
    greedy tokens equal, logits within phase 11's 0.07 (bitwise printed),
    walls and peaks; every prefill launch of kernel 8 on "mma", every
    decode launch on "split".  (b) Kernel 8's split decode merged across
    sequence slices (:func:`merge_emulation`).  (c) Qwen3-30B-A3B and
    DeepSeek-V2 at phase 25's depths: prefill 4 × 2048, ``MESH_MOE_STEPS``
    greedy steps, expert ids equal on every (token, layer), greedy tokens
    equal, the largest logit difference."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.batches import lm_batch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as tx

    mesh = make_local_mesh((1, 1), ("data", "model"), device=dev)
    res = {"mesh": f"{mesh.device_type} mesh {tuple(mesh.shape)} over "
                   f"{mesh.mesh_dim_names}"}
    check(mesh.device_type == "cuda", f"an NCCL mesh: {res['mesh']}")

    b, s, max_len, steps = LM_SERVE_SHAPE
    arch = get_arch("llama3_2_1b")
    cfg = arch.config
    gen = torch.Generator(device=dev).manual_seed(0)
    toks = torch.from_numpy(lm_batch(b, s, cfg.vocab, seed=0)["tokens"]
                            ).to(dev)
    # the model is handed over, not kept: the pair frees it at its end
    a = mesh_serve_pair(arch, mesh, tx.Transformer(cfg, tx.init_params(
        cfg, gen)), toks, max_len, steps,
        before=lambda m, plans: merge_emulation(m, plans, toks, max_len))
    res["merge"] = a.pop("before")
    ln = a["mesh"]["launches"]
    check(a["tokens_equal"], "Llama: greedy tokens mesh == no mesh")
    check(a["max_logit_diff"] <= 0.07,
          f"Llama: logits mesh vs no mesh {a['max_logit_diff']} > 0.07")
    check(a["mesh"]["len"] == [s + steps] * b, "Llama: mesh cache len")
    check(ln["prefill routes"]["mma"] == ln["flash prefill"] == cfg.n_layers,
          f"Llama mesh prefill launches {ln}")
    check(ln["decode routes"]["split"] == ln["flash decode"]
          == cfg.n_layers * steps, f"Llama mesh decode launches {ln}")
    res["llama"] = a
    gc.collect()
    torch.cuda.empty_cache()

    b, s, max_len, _ = MOE_LM_SHAPE
    res["moe"] = {}
    for name, depth in MOE_LM_DEPTH.items():
        full = get_arch(name)
        cfg = dataclasses.replace(full.config, n_layers=depth)
        arch = dataclasses.replace(full, config=cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        toks = torch.from_numpy(lm_batch(b, s, cfg.vocab, seed=0)["tokens"]
                                ).to(dev)
        o = mesh_serve_pair(arch, mesh, tx.Transformer(cfg, tx.init_params(
            cfg, gen)), toks, max_len, MESH_MOE_STEPS)
        n_moe = cfg.layer_counts()[1]
        ln = o["mesh"]["launches"]
        o["reduced"] = (f"n_layers {full.config.n_layers} -> {depth}; "
                        f"prefill_32k / decode_32k -> {b} x {s}, max_len "
                        f"{max_len}, {MESH_MOE_STEPS} decode steps")
        check(o["ids_equal"] and o["pairs"] > 0,
              f"{name}: expert ids mesh == no mesh on all (token, layer)")
        check(o["tokens_equal"], f"{name}: greedy tokens mesh == no mesh")
        check(ln["select"] == n_moe * (1 + MESH_MOE_STEPS) > 0
              and ln["flash prefill"] == depth,
              f"{name}: mesh launches {ln}")
        if cfg.mla is None:
            check(ln["decode routes"]["split"] == depth * MESH_MOE_STEPS,
                  f"{name}: mesh decode launches {ln}")
        res["moe"][name] = o
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return res


# -- the GNN family (EGNN) ---------------------------------------------------

# minibatch_lg's synthetic Reddit: the node count and width are the
# cell's; its 114,615,892 edges are cut 10× to keep the host's generation
# and CSR sort (tens of seconds at full size) inside the phase's time.
# The device shapes depend only on the seeds and fanouts: at a mean
# in-degree of 49 every seed has 15 neighbours and every hop-1 node 10.
GNN_REDDIT_EDGES = 11_461_589
# ogb_products' 61,859,140 edges cut to what one 80 GB card holds in a
# 4-layer f32 train step with ~20 % of it free; phase 28 (c) checks the
# cut each run: it steps on the first 2^20 and 2^21 edges of the graph
# (the full node count and width) and prints the peak's growth an edge
# and the edge count that would fill 80 % of the card
GNN_PRODUCTS_EDGES = 6_000_000
GNN_PRODUCTS_PROBES = (1 << 20, 1 << 21)
# card vs CPU, and a rotated input vs the plain one: of max(1, |x|) a
# tensor, f32 with TF32 off (cuBLAS and the CPU's GEMMs round apart)
GNN_TOL = 1e-4
GNN_SMOKE_STEPS = 20


def padded_graph(n_nodes, n_edges, d_feat, n_classes):
    """``synthetic_graph`` with ``pad_edges``' padding: one dummy node
    (features and coordinates 0, label −1) and dummy → dummy edges up to
    ``pad_edges(n_edges)``; the host seconds it took."""
    from repro_torch.configs.registry import pad_edges
    from repro_torch.data.graph import GraphSpec, synthetic_graph
    t0 = time.perf_counter()
    g = synthetic_graph(GraphSpec(n_nodes, n_edges, d_feat, n_classes))
    pad = np.full((2, pad_edges(n_edges) - n_edges), n_nodes, np.int32)
    out = {"feat": np.concatenate([g["feat"], np.zeros((1, d_feat),
                                                       np.float32)]),
           "coord": np.concatenate([g["coord"], np.zeros((1, 3),
                                                         np.float32)]),
           "edges": np.concatenate([g["edges"], pad], axis=1),
           "labels": np.concatenate([g["labels"], [-1]]).astype(np.int32)}
    return out, time.perf_counter() - t0


def on_device(batch, dev):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def egnn_grads(model, batch):
    """The loss and the gradient leaves of ``model`` on ``batch`` (zeros
    where no gradient arrives, as the train step takes them)."""
    from repro_torch.distributed.checkpoint import tree_flatten
    from repro_torch.training.train_loop import take_grads, trainable
    tree = trainable(model.tree())
    loss = model.loss(batch)
    loss.backward()
    return loss.detach(), tree_flatten(take_grads(tree))


def leaves_apart(got, want):
    """(the non-finite element masks equal on every leaf, the largest
    difference of the finite elements over max(1, |want|) of its leaf)."""
    same, worst = True, 0.0
    for g, w in zip(got, want):
        g, w = g.detach().float().cpu(), w.detach().float().cpu()
        fin = torch.isfinite(w)
        same &= bool(torch.equal(fin, torch.isfinite(g)))
        if fin.any():
            scale = max(1.0, float(w[fin].abs().max()))
            worst = max(worst, float((g[fin] - w[fin]).abs().max()) / scale)
    return same, worst


def nan_equal(a, b) -> bool:
    """Bitwise equal, NaN where and only where the other is NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def egnn_steps(plan, model, batch, n=2):
    """``n`` steps of a GNN plan from a fresh AdamW state: the losses,
    walls (s), the peak GiB and the model."""
    state = plan.optimizer.init(model.tree())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_bytes = torch.cuda.memory_allocated()
    losses, walls = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        model, state, loss = plan.fn(model, state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(loss.detach())
    peak = torch.cuda.max_memory_allocated()
    return {"losses": losses, "walls": walls, "model": model,
            "peak_gib": peak / 2**30, "peak_bytes": peak,
            "reset_bytes": reset_bytes}


def phase_gnn(dev):
    """Phase 28: EGNN at its full width (4 layers, hidden 64, d_out 47;
    f32, TF32 off), every cell through ``build_step``: (a) full_graph_sm
    at full size against the port's CPU run from the same weights —
    forward, loss, gradients (the non-finite leaves equal), one AdamW
    step — the card run twice bitwise, and the E(n) check; (b)
    minibatch_lg on the sampler's subgraph of a synthetic Reddit; (c)
    ogb_products at its full node count and width, edges cut; (d)
    molecule, the batched forward against a loop over its graphs; each
    with two steps' walls and the peak; (e) the meshed plans of (a), (b)
    and (d) on a one-rank NCCL mesh against the no-mesh plans, bitwise;
    (f) ``launch.train --arch egnn --smoke``."""
    import dataclasses

    from repro_torch.configs import get_arch, input_specs
    from repro_torch.data.graph import NeighborSampler, molecules_batch
    from repro_torch.data.graph import GraphSpec, synthetic_graph
    from repro_torch.distributed.checkpoint import tree_flatten, tree_unflatten
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_step, place_model
    from repro_torch.models import egnn as eg

    arch = get_arch("egnn")
    res, batches, inits = {}, {}, {}
    cpu = torch.device("cpu")

    def model_for(cell_name, device=dev):
        """A fresh EGNN at the cell's width on ``device``, from one seeded
        draw a cell (made on the card), so every run of a cell starts
        from the same weights."""
        cfg = dataclasses.replace(arch.config,
                                  d_feat=arch.cell(cell_name).dims["d_feat"])
        if cell_name not in inits:
            inits[cell_name] = eg.init_params(
                cfg, torch.Generator(device=dev).manual_seed(0))
        tree = inits[cell_name]
        return eg.EGNN(cfg, tree_unflatten(tree, [
            p.detach().clone().to(device) for p in tree_flatten(tree)]))

    def specs_match(cell_name, batch):
        want = input_specs(arch, arch.cell(cell_name))
        return {k: tuple(v.shape) for k, v in batch.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}

    # (a) full_graph_sm, card against the CPU from the same weights
    d = arch.cell("full_graph_sm").dims
    host, gen_s = padded_graph(d["n_nodes"], d["n_edges"], d["d_feat"],
                               arch.config.d_out)
    check(specs_match("full_graph_sm", host),
          "full_graph_sm: the padded graph has input_specs' shapes")
    batch = batches["full_graph_sm"] = on_device(host, dev)
    model, ref = model_for("full_graph_sm"), model_for("full_graph_sm", cpu)
    logits, coords = model.forward(batch)
    want_logits, want_coords = ref.forward(host)
    a = {"nodes": host["feat"].shape[0], "edges": host["edges"].shape[1],
         "self_loops": int((host["edges"][0] == host["edges"][1]).sum()),
         "gen_s": gen_s,
         "logits": leaves_apart([logits], [want_logits])[1],
         "coords": leaves_apart([coords], [want_coords])[1]}
    loss, grads = egnn_grads(model, batch)
    loss2, grads2 = egnn_grads(model, batch)
    want_loss, want_grads = egnn_grads(ref, host)
    a["loss"] = (float(loss), float(want_loss))
    a["loss_err"] = leaves_apart([loss], [want_loss])[1]
    a["nonfinite_equal"], a["grad_err"] = leaves_apart(grads, want_grads)
    a["nonfinite"] = sum(not bool(torch.isfinite(g).all()) for g in grads)
    a["leaves"] = len(grads)
    a["rerun_bitwise"] = bool(torch.equal(loss, loss2)) and all(
        nan_equal(g, h) for g, h in zip(grads, grads2))
    # E(n): rotate and translate the coordinates
    rng = np.random.default_rng(28)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    q = torch.from_numpy(q.astype(np.float32)).to(dev)
    shift = torch.from_numpy(rng.normal(size=3).astype(np.float32)).to(dev)
    moved = dict(batch, coord=batch["coord"] @ q.T + shift)
    logits_m, coords_m = model.forward(moved)
    a["equiv_logits"] = leaves_apart([logits_m], [logits])[1]
    a["equiv_coords"] = leaves_apart([coords_m], [coords @ q.T + shift])[1]
    plan = build_step(arch, arch.cell("full_graph_sm"))
    run = egnn_steps(plan, model, batch, n=1)
    ref_state = plan.optimizer.init(ref.tree())
    ref, _, ref_loss = plan.fn(ref, ref_state, host)
    a["step_loss"] = (float(run["losses"][0]), float(ref_loss))
    a["step_nonfinite_equal"], a["step_err"] = leaves_apart(
        tree_flatten(run["model"].tree()), tree_flatten(ref.tree()))
    a["walls"], a["peak_gib"] = run["walls"], run["peak_gib"]
    check(a["logits"] <= GNN_TOL and a["coords"] <= GNN_TOL
          and a["loss_err"] <= GNN_TOL and a["grad_err"] <= GNN_TOL,
          f"full_graph_sm card vs CPU within {GNN_TOL}: {a}")
    check(a["nonfinite_equal"] and a["step_nonfinite_equal"],
          f"full_graph_sm: the non-finite leaves card == CPU: {a}")
    # AdamW's first step moves an element by its rate (3e-4) whatever |g|,
    # so a gradient within rounding of 0 may step the other way on the
    # card: twice the rate bounds that
    check(a["step_err"] <= 2 * 3e-4 + GNN_TOL,
          f"full_graph_sm step card vs CPU within 2·lr: {a}")
    check(a["rerun_bitwise"], "full_graph_sm: two card runs bitwise")
    check(a["equiv_logits"] <= GNN_TOL and a["equiv_coords"] <= GNN_TOL,
          f"full_graph_sm E(n) within {GNN_TOL}: {a}")
    res["full_graph_sm"] = a
    del model, ref, run, grads, grads2, want_grads

    # (b) minibatch_lg: a sampled subgraph of a synthetic Reddit
    d = arch.cell("minibatch_lg").dims
    t0 = time.perf_counter()
    g = synthetic_graph(GraphSpec(d["n_nodes"], GNN_REDDIT_EDGES,
                                  d["d_feat"], arch.config.d_out))
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sampler = NeighborSampler(g["edges"], d["n_nodes"],
                              (d["fanout1"], d["fanout2"]), seed=0)
    csr_s = time.perf_counter() - t0
    seeds = np.random.default_rng(0).choice(d["n_nodes"], d["batch_nodes"],
                                            replace=False)
    t0 = time.perf_counter()
    host = sampler.sample(seeds, g["feat"], g["coord"], g["labels"])
    sample_s = time.perf_counter() - t0
    del g, sampler
    used = np.union1d(np.unique(host["edges"]),
                      np.arange(d["batch_nodes"]))
    real = int(((host["edges"][0] != 0) | (host["edges"][1] != 0)).sum())
    b = {"graph_edges": GNN_REDDIT_EDGES, "gen_s": gen_s, "csr_s": csr_s,
         "sample_s": sample_s, "budget": host["feat"].shape,
         "edge_budget": host["edges"].shape[1], "nodes_used": used.size,
         "edges_real": real}
    batch = batches["minibatch_lg"] = on_device(host, dev)
    run = egnn_steps(build_step(arch, arch.cell("minibatch_lg")),
                     model_for("minibatch_lg"), batch)
    b.update(losses=[float(x) for x in run["losses"]], walls=run["walls"],
             peak_gib=run["peak_gib"])
    res["minibatch_lg"] = b
    del run, host

    # (c) ogb_products at its full node count and width, edges cut; the
    # peak first on the graph's first GNN_PRODUCTS_PROBES edges
    d = arch.cell("ogb_products").dims
    host, gen_s = padded_graph(d["n_nodes"], GNN_PRODUCTS_EDGES, d["d_feat"],
                               arch.config.d_out)
    batch = on_device(host, dev)
    del host
    plan = build_step(arch, arch.cell("ogb_products"))
    probes = [egnn_steps(plan, model_for("ogb_products"), dict(
        batch, edges=batch["edges"][:, :e]), n=1)["peak_gib"]
        for e in GNN_PRODUCTS_PROBES]
    (e1, e2), (p1, p2) = GNN_PRODUCTS_PROBES, probes
    per_edge = (p2 - p1) / (e2 - e1)
    total = torch.cuda.get_device_properties(dev).total_memory / 2**30 \
        if dev.type == "cuda" else float("nan")
    run = egnn_steps(plan, model_for("ogb_products"), batch)
    res["ogb_products"] = {
        "graph_edges": GNN_PRODUCTS_EDGES,
        "edges": int(batch["edges"].shape[1]),
        "nodes": int(batch["feat"].shape[0]), "gen_s": gen_s,
        "losses": [float(x) for x in run["losses"]], "walls": run["walls"],
        "peak_gib": run["peak_gib"], "peak_bytes": run["peak_bytes"],
        "reset_bytes": run["reset_bytes"],
        "probes": dict(zip((e1, e2), probes)),
        "kib_per_edge": per_edge * 2**20, "total_gib": total,
        "fits_80pc": (0.8 * total - (p1 - per_edge * e1)) / per_edge
        if per_edge > 0 else float("nan")}
    del run, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (d) molecule: the batched forward against a loop over the graphs
    d = arch.cell("molecule").dims
    host = molecules_batch(d["batch"], d["n_nodes"], d["n_edges"],
                           d["d_feat"])
    check(specs_match("molecule", host),
          "molecule: the batch has input_specs' shapes")
    batch = batches["molecule"] = on_device(host, dev)
    model = model_for("molecule")
    logits, coords = model.forward_batched(batch)
    looped = [model.forward({k: v[i] for k, v in batch.items()
                             if k != "labels"}) for i in range(d["batch"])]
    m = {"loop_logits": leaves_apart(
            [logits], [torch.stack([x[0] for x in looped])])[1],
         "loop_coords": leaves_apart(
            [coords], [torch.stack([x[1] for x in looped])])[1]}
    check(m["loop_logits"] <= 1e-5 and m["loop_coords"] <= 1e-5,
          f"molecule: batched forward == the loop within 1e-5: {m}")
    run = egnn_steps(build_step(arch, arch.cell("molecule")), model, batch)
    m.update(losses=[float(x) for x in run["losses"]], walls=run["walls"],
             peak_gib=run["peak_gib"])
    res["molecule"] = m
    del run, model

    # (e) the meshed plans on a one-rank NCCL mesh against the no-mesh ones
    mesh = make_local_mesh((1, 1), ("data", "model"), device=dev)
    res["mesh"] = f"{mesh.device_type} mesh {tuple(mesh.shape)} over " \
                  f"{mesh.mesh_dim_names}"
    check(mesh.device_type == "cuda", f"an NCCL mesh: {res['mesh']}")
    res["mesh_pairs"] = {}
    for cell_name, batch in batches.items():
        cell = arch.cell(cell_name)
        plain_model = model_for(cell_name)
        mesh_plan = build_step(arch, cell, mesh)
        mesh_model = place_model(model_for(cell_name),
                                 mesh_plan.in_shardings[0])
        plain = egnn_steps(build_step(arch, cell), plain_model, batch, n=1)
        meshed = egnn_steps(mesh_plan, mesh_model, batch, n=1)
        got = [p.full_tensor() for p in tree_flatten(meshed["model"].tree())]
        want = tree_flatten(plain["model"].tree())
        pair = {"loss_bitwise": nan_equal(meshed["losses"][0],
                                          plain["losses"][0]),
                "params_bitwise": all(nan_equal(x, y)
                                      for x, y in zip(got, want)),
                "walls": (plain["walls"][0], meshed["walls"][0]),
                "peak_gib": (plain["peak_gib"], meshed["peak_gib"])}
        check(pair["loss_bitwise"] and pair["params_bitwise"],
              f"{cell_name}: meshed step == no-mesh step bitwise: {pair}")
        res["mesh_pairs"][cell_name] = pair
        del plain, meshed, got, want, plain_model, mesh_model
    batches.clear()

    # (f) the launcher's smoke run on the card
    t0 = time.perf_counter()
    out, before, after = launch_train.main(
        ["--arch", "egnn", "--smoke", "--steps", str(GNN_SMOKE_STEPS),
         "--device", dev.type])
    res["train"] = {"losses": out.losses, "before": before, "after": after,
                    "wall_s": time.perf_counter() - t0}
    check(len(out.losses) == GNN_SMOKE_STEPS
          and all(math.isfinite(x) for x in out.losses + [before, after]),
          f"launch.train --arch egnn --smoke: finite losses {res['train']}")
    gc.collect()
    torch.cuda.empty_cache()
    return res


def log_gnn(gn, card) -> None:
    """Phase 28's lines: each cell's checks, walls and peaks beside the
    card's name and power limit."""
    a = gn["full_graph_sm"]
    log(f"    full_graph_sm ({a['nodes']} nodes with the dummy, {a['edges']} "
        f"edges padded by pad_edges, {a['self_loops']} self-loops): card vs "
        f"CPU from the same weights, of max(1, |x|): logits {a['logits']!r}, "
        f"coords {a['coords']!r}, loss {a['loss']} ({a['loss_err']!r}), "
        f"gradients {a['grad_err']!r} (limit {GNN_TOL}); non-finite leaves "
        f"{a['nonfinite']} of {a['leaves']}, equal on card and CPU "
        f"{a['nonfinite_equal']}; two card runs bitwise "
        f"{a['rerun_bitwise']}; E(n): logits {a['equiv_logits']!r}, coords "
        f"{a['equiv_coords']!r} (limit {GNN_TOL})")
    log(f"    full_graph_sm build_step: loss card / CPU {a['step_loss']}, "
        f"params {a['step_err']!r} apart (limit 2 * 3e-4 + {GNN_TOL}), "
        f"non-finite equal {a['step_nonfinite_equal']}; step wall "
        f"{a['walls'][0]:.4f} s, peak {a['peak_gib']:.2f} GiB on {card}")
    b = gn["minibatch_lg"]
    log(f"    minibatch_lg: synthetic Reddit of {b['graph_edges']} edges "
        f"(cut from 114615892) made in {b['gen_s']:.2f} s host, CSR "
        f"{b['csr_s']:.2f} s, sampler {b['sample_s']:.3f} s host for "
        f"{b['budget']} features, {b['nodes_used']} nodes used, "
        f"{b['edges_real']} of {b['edge_budget']} edges sampled; step walls "
        f"{[round(x, 4) for x in b['walls']]} s, peak {b['peak_gib']:.2f} "
        f"GiB, losses {b['losses']} on {card}")
    o = gn["ogb_products"]
    log(f"    ogb_products: {o['nodes']} nodes, {o['edges']} edges (cut from "
        f"61859140 to {o['graph_edges']}, padded), graph {o['gen_s']:.2f} s "
        f"host; step walls {[round(x, 4) for x in o['walls']]} s, peak "
        f"{o['peak_gib']:.2f} GiB of {o['total_gib']:.2f}, losses "
        f"{o['losses']} on {card}; peaks at the probes' edge counts "
        f"{o['probes']} GiB: {o['kib_per_edge']:.3f} KiB an edge, "
        f"{o['fits_80pc']:.0f} edges would fill 80 % of the card")
    m = gn["molecule"]
    log(f"    molecule (128 graphs x 30 nodes, 64 edges): batched forward vs "
        f"the loop, logits {m['loop_logits']!r}, coords {m['loop_coords']!r} "
        f"(limit 1e-5); step walls {[round(x, 4) for x in m['walls']]} s, "
        f"peak {m['peak_gib']:.2f} GiB, losses {m['losses']} on {card}")
    for name, pr in gn["mesh_pairs"].items():
        log(f"    {name} on the {gn['mesh']}: loss and params == no mesh "
            f"bitwise {pr['loss_bitwise'] and pr['params_bitwise']}; walls "
            f"(s) no mesh / mesh {tuple(round(x, 4) for x in pr['walls'])}, "
            f"peak GiB {tuple(round(x, 2) for x in pr['peak_gib'])}")
    t = gn["train"]
    log(f"    launch.train --arch egnn --smoke --steps {GNN_SMOKE_STEPS}: "
        f"losses {[round(x, 5) for x in t['losses']]}, step 0's batch "
        f"{t['before']!r} -> {t['after']!r}, {t['wall_s']:.2f} s")


# phase 29: the dry run's estimate against the card's reading
ESTIMATE_RATIO = (0.90, 1.10)   # estimated / measured peak bytes
DRYRUN_TIMEOUT = 600            # s, the production-mesh dry run's process


def phase_estimates(lt, gn):
    """Phase 29: the no-mesh dry run (``repro_torch.launch.dryrun.
    estimate``: the step counted on meta tensors, no data, nothing on the
    card) of phase 23's Llama-3.2-1B train step and of phase 28's
    ogb_products step at its edge cut, each held to the card's peak over
    that phase's timed steps (``reset_peak_memory_stats`` just before
    them), which ran on the card earlier in this run; the counted flops
    and matmul flops beside the warm step wall.  Then one cell of the
    production mesh, Llama-3.2-1B train_4k on (16, 16), through the dry
    run's CLI in its own process (a fake group of 256 ranks, this
    machine's torch)."""
    import dataclasses
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import estimate

    egnn = get_arch("egnn")
    products = dataclasses.replace(
        egnn.cell("ogb_products"), dims={
            **egnn.cell("ogb_products").dims,
            "n_edges": GNN_PRODUCTS_EDGES})
    o = gn["ogb_products"]
    cases = {"llama3_2_1b train step": (lm_train_cell(), lt["peak_bytes"],
                                        lt["reset_bytes"], lt["warm_s"]),
             "egnn ogb_products step": ((egnn, products), o["peak_bytes"],
                                        o["reset_bytes"], o["walls"][-1])}
    out = {}
    for name, ((arch, cell), peak, reset, warm_s) in cases.items():
        rec = estimate(arch, cell)
        mem = rec["memory"]
        out[name] = {
            "estimated_peak": mem["peak_bytes"], "measured_peak": peak,
            "ratio": mem["peak_bytes"] / peak,
            "estimated_arguments": mem["argument_bytes"],
            "allocated_at_reset": reset, "flops": rec["flops_per_device"],
            "matmul_flops": rec["matmul_flops"], "warm_s": warm_s,
            "kernels": rec["kernels"], "trace_s": rec["trace_s"],
            "cell": f"{cell.name} {cell.dims}"}
    with tempfile.TemporaryDirectory() as tmp:
        rec_path = os.path.join(tmp, "llama3_2_1b__train_4k.json")
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "llama3_2_1b", "--shape", "train_4k", "--out", rec_path],
            capture_output=True, text=True, timeout=DRYRUN_TIMEOUT,
            env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
        check(run.returncode == 0,
              f"the production-mesh dry run exits 0: {run.stderr[-2000:]}")
        with open(rec_path) as f:
            out["mesh"] = json.load(f)
        out["mesh"]["wall_s"] = time.perf_counter() - t0
    return out


def log_estimates(es, card) -> None:
    """Phase 29's lines, checked: each ratio inside ``ESTIMATE_RATIO``."""
    lo, hi = ESTIMATE_RATIO
    for name, r in es.items():
        if name == "mesh":
            continue
        log(f"    {name} ({r['cell']}): peak estimated {r['estimated_peak']} "
            f"B ({r['estimated_peak'] / 2**30:.2f} GiB), measured "
            f"{r['measured_peak']} B ({r['measured_peak'] / 2**30:.2f} GiB): "
            f"ratio {r['ratio']!r} (limit [{lo}, {hi}]); arguments "
            f"estimated {r['estimated_arguments'] / 2**30:.2f} GiB, the "
            f"card's allocation at the reset "
            f"{r['allocated_at_reset'] / 2**30:.2f} GiB; counted "
            f"{r['flops']!r} flops ({r['matmul_flops']!r} in matmuls; "
            f"kernels {r['kernels']}) beside a warm step of "
            f"{r['warm_s']:.4f} s, {r['flops'] / r['warm_s'] / 1e12:.1f} "
            f"counted TFLOP/s on {card}; the trace {r['trace_s']} s host")
        check(lo <= r["ratio"] <= hi,
              f"{name}: estimated / measured peak {r['ratio']!r} inside "
              f"[{lo}, {hi}]")
    m = es["mesh"]
    log(f"    {m['arch']} {m['shape']} on the {m['mesh']} mesh "
        f"({m['n_devices']} fake ranks): per device "
        f"{m['flops_per_device']!r} flops, {m['matmul_flops']!r} in "
        f"matmuls, {m['bytes_accessed_per_device']!r} bytes, peak "
        f"{m['memory']['peak_bytes'] / 2**30:.2f} GiB, collective bytes "
        f"{ {k: v['bytes'] for k, v in m['collectives'].items()} }; the "
        f"process {m['wall_s']:.1f} s")
    check(m["n_devices"] == 256 and m["collective_bytes_total"] > 0,
          "the production-mesh dry run counts its collectives")


# phase 30: the port's examples in this process.  What the reference's
# examples/quickstart.py prints on the CPU (MAE / P / R / F1 as printed,
# and the pcc top-5 of users 0-2, every shown score 5.00)
QUICKSTART_METRICS = {"jaccard": ("0.8977", "0.618", "0.602", "0.610"),
                      "cosine": ("0.8545", "0.661", "0.606", "0.633"),
                      "pcc": ("0.8114", "0.678", "0.671", "0.674")}
QUICKSTART_TOP5 = {0: (118, 131, 172, 205, 274),
                   1: (205, 216, 454, 468, 664),
                   2: (37, 227, 331, 345, 356)}
TOP5_TIE = 1e-5
# examples/serve_recommendations.py's update line on its default
# (sequential) backend: (rows recomputed, rows merged)
SERVE_UPDATE = (253, 771)
# the LM example at its defaults (200 steps, batch 8, seq 128) with a fault
# at step 120; a CPU rehearsal cuts the model and the run with these
EXAMPLE_LM_ARGS = ["--inject-fault-at", "120"]
EXAMPLE_LM_CONFIG = {}          # build_config overrides
EXAMPLE_LM_CKPT_EVERY = 50
EXAMPLE_CF_ARGS = []            # the sweep at its defaults (2048 x 1024)


def load_example(name):
    """``examples/<name>.py`` imported as a module (its ``main`` not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(fn, *args, **kw):
    """``fn(*args, **kw)`` (an example's ``main``) with every launch count
    set to 0 just before and read just after, its stdout captured and
    logged indented.  Returns (its result, its stdout, launches by wrapper
    name, flash forward / backward launches by route, wall s)."""
    import contextlib
    import io
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    zero_counts()
    fwd0 = dict(flash_attention.routes)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in all_wrappers().values()}
    routes = {"forward": {r: n - fwd0[r]
                          for r, n in flash_attention.routes.items()},
              "backward": dict(flash_attention_bwd.routes)}
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"      | {line}")
    return out, text, launches, routes, wall


def top5_agree(got, want, pred, seen, tol=TOP5_TIE) -> bool:
    """Two top-5 lists of one user agree if they are equal, or differ only
    in unseen items whose predictions lie within ``tol`` of the cut (the
    5th best prediction among the unseen items)."""
    if list(got) == list(want):
        return True
    scores = torch.where(seen, torch.full_like(pred, float("-inf")), pred)
    cut = float(torch.sort(scores, descending=True).values[len(got) - 1])
    return all(abs(float(scores[i]) - cut) <= tol
               for i in set(got) ^ set(want))


def phase_examples(dev):
    """Phase 30: the four port examples through their ``main(argv)`` in
    this process (no new CUDA context, nothing rebuilt), then ``python -m
    repro_torch.analysis``'s checks, each with its own launch counts."""
    import re
    import shutil
    import tempfile

    from repro_torch import analysis, obs
    from repro_torch.analysis import precision as P

    on = ["--device", str(dev)]
    total: dict = {}
    out = {}

    def run(label, fn, *args, **kw):
        res, text, launches, routes, wall = run_example(fn, *args, **kw)
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        out[label] = {"launches": {k: v for k, v in launches.items() if v},
                      "routes": routes, "wall_s": wall}
        return res, text

    # (a) quickstart: the reference's printed metrics, its top-5 (ties)
    qs, text = run("quickstart", load_example("torch_quickstart").main, on)
    got = {m: (f"{ev['mae']:.4f}", f"{ev['precision']:.3f}",
               f"{ev['recall']:.3f}", f"{ev['f1']:.3f}")
           for m, ev in qs["metrics"].items()}
    check(got == QUICKSTART_METRICS,
          f"quickstart metrics {got} == the reference's {QUICKSTART_METRICS}")
    pred = qs["model"].predict(qs["train"])[:3].cpu()
    seen = (qs["train"][:3] > 0).cpu()
    for u, want in QUICKSTART_TOP5.items():
        items = [int(i) for i in qs["items"][u]]
        check(top5_agree(items, want, pred[u], seen[u]),
              f"quickstart user {u}: top-5 {items} == the reference's "
              f"{want} up to ties within {TOP5_TIE}")
    out["quickstart"]["top5"] = {u: [int(i) for i in qs["items"][u]]
                                 for u in QUICKSTART_TOP5}
    out["quickstart"]["metrics"] = got

    # (b) serving: exact on the kernel backend (its update refits every
    # row, as the reference's pallas backend does) and on the default
    # backend (the reference's update line), then approx on the kernels
    serve = load_example("torch_serve_recommendations").main
    for label, argv in (("serve kernel", ["--backend", "kernel"]),
                        ("serve sequential", []),
                        ("serve approx", ["--backend", "kernel",
                                          "--neighbor-mode", "approx"])):
        sv, text = run(label, serve, argv + on)
        st, s = sv["update"], sv["stats"]
        check(len(sv["results"]) == 64 and s["n_requests"] == 64,
              f"{label}: every one of 64 requests answered "
              f"({len(sv['results'])} results, {s['n_requests']} served)")
        out[label].update(
            update=(st.n_affected, st.n_merged), req_per_s=64 / sv["seconds"],
            p50_ms=s["latency_p50_ms"], p99_ms=s["latency_p99_ms"],
            recall=sv["recall"])
    n_users = 1024
    check(out["serve kernel"]["update"] == (n_users, 0),
          f"serve kernel: the update refits every row "
          f"{out['serve kernel']['update']}")
    check(out["serve sequential"]["update"] == SERVE_UPDATE,
          f"serve sequential: update {out['serve sequential']['update']} == "
          f"the reference's {SERVE_UPDATE}")

    # (c) the paper's sweep: sequential and ring (one-rank mesh), equal CSVs
    sweep = load_example("torch_train_cf_movielens").main
    rows = {}
    for engine in ("sequential", "ring"):
        res, _ = run(f"sweep {engine}", sweep,
                     EXAMPLE_CF_ARGS + ["--engine", engine] + on)
        rows[engine] = [r.split(",")[:2] + r.split(",")[3:] for r in res]
    check(rows["sequential"] and rows["sequential"] == rows["ring"],
          "the ring sweep's CSV == the sequential sweep's but fit_s")
    out["sweep"] = rows["sequential"]

    # (d) the ~100M LM with a fault: one restart, the loss falls (the
    # example's own assert), kernels 8 / 8b on their f32 route
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_lm_")
    try:
        res, text = run("train_lm", load_example("torch_train_lm").main,
                        EXAMPLE_LM_ARGS + ["--ckpt-dir", ckpt] + on,
                        checkpoint_every=EXAMPLE_LM_CKPT_EVERY,
                        **EXAMPLE_LM_CONFIG)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    check(res.restarts == 1, f"train_lm restarts {res.restarts} == 1")
    out["train_lm"].update(
        restarts=res.restarts, steps=res.final_step,
        first=float(np.mean(res.losses[:10])),
        last=float(np.mean(res.losses[-10:])),
        params=re.search(r"([\d.]+M) params", text).group(1))
    r = out["train_lm"]["routes"]
    check(r["forward"]["simt"] > 0 and r["backward"]["simt"] > 0,
          f"train_lm: kernels 8 / 8b on \"simt\" {r}")

    # (e) the trace-level checks: exit 0, the committed audit's widenings,
    # no compile event in a warm window
    audit = os.path.join(ROOT, P.AUDIT_FILE)
    rc, _ = run("analysis", analysis.main,
                ["--precision-audit", audit] + on)
    check(rc == 0, f"python -m repro_torch.analysis exits {rc}")
    live = sorted(w.symbol for w in P.run_precision_audit(device=dev))
    committed = sorted(sym for (_, _, sym) in P.load_audit(audit))
    check(live == committed,
          f"widenings on the card {live} == {P.AUDIT_FILE} {committed}")
    count = obs.registry().gauge("analysis.retrace.count").value
    check(count == 0, f"compile events in the warm windows: {count}")
    out["analysis"].update(widenings=live, retrace=count)

    out["launches"] = total
    ported = ("fused_similarity", "fused_tile_predict",
              "fused_centroid_distances", "fused_scan_topm", "select_topm",
              "fused_rerank_scores", "flash_attention", "flash_attention_bwd")
    check(all(total[k] > 0 for k in ported),
          f"phase 30 launches kernels 1-6, 8 and 8b: {total}")
    return out


def log_examples(ex, card) -> None:
    """Phase 30's lines."""
    for label in ("quickstart", "serve kernel", "serve sequential",
                  "serve approx", "sweep sequential", "sweep ring",
                  "train_lm", "analysis"):
        o = ex[label]
        log(f"    {label}: {o['wall_s']:.2f} s, launches {o['launches']}")
    log(f"    quickstart metrics (MAE, P, R, F1) {ex['quickstart']['metrics']}"
        f" == the reference's CPU printout; top-5 {ex['quickstart']['top5']}")
    for label in ("serve kernel", "serve sequential", "serve approx"):
        o = ex[label]
        log(f"    {label}: update (recomputed, merged) {o['update']}, "
            f"{o['req_per_s']:.1f} req/s, p50 {o['p50_ms']:.1f} ms, p99 "
            f"{o['p99_ms']:.1f} ms"
            + (f", recall@40 vs exact {o['recall']!r}"
               if o["recall"] is not None else "") + f" on {card}")
    log(f"    sweep: ring == sequential ({len(ex['sweep'])} rows, fit_s "
        f"aside); pcc rows {[r for r in ex['sweep'] if r[0] == 'pcc']}")
    t = ex["train_lm"]
    log(f"    train_lm ({t['params']} params): {t['steps']} steps, "
        f"restarts {t['restarts']}, loss {t['first']!r} -> {t['last']!r}, "
        f"flash routes {t['routes']}, {t['wall_s']:.2f} s on {card}")
    a = ex["analysis"]
    log(f"    python -m repro_torch.analysis --device cuda: exit 0, "
        f"widenings {a['widenings']}, compile events in warm windows "
        f"{a['retrace']!r}")
    log(f"    launches in phase 30: {ex['launches']}")


# phase 31: DeepSeek-V2's train step at full width through kernels 8 and
# 8b at MLA's 192 / 128 heads.  One layer: a 160-expert MoE layer is 3.8 B
# parameters, 61 GB with AdamW's f32 state, beside 1.39 B of the first
# (dense) layer and the two 102,400 × 5120 embeddings; MoE training waits
# for a mesh.  The µbatch is the most rows whose step the dry run
# (launch/dryrun.py at this config) puts under 72 GB: 16 rows 59.3 GiB,
# 32 rows 90.4 GiB
MLA_TRAIN_DEPTH = 1
MLA_TRAIN_SHAPE = (32, 4096)    # train_4k's seq 4096, batch cut from 256
MLA_TRAIN_MICROBATCH = 2        # µbatches of 16 rows
MLA_TRAIN_STEPS = 2             # timed; one more under the profiler
MLA_GRAD_ROWS = 1               # (a)'s batch: the plain attention's
#                                 autograd keeps 128 heads' f32 scores
MLA_PEAK_LIMIT = 72e9           # bytes: what the µbatch was sized to


def mla_train_cell():
    """Phase 31's uncut arch, its cut arch and its cell: DeepSeek-V2 at
    ``MLA_TRAIN_DEPTH`` layers with ``MLA_TRAIN_MICROBATCH`` µbatches and
    remat, train_4k's seq with the batch cut to ``MLA_TRAIN_SHAPE``'s."""
    import dataclasses

    from repro_torch.configs import get_arch
    b, s = MLA_TRAIN_SHAPE
    full = get_arch("deepseek_v2_236b")
    cfg = dataclasses.replace(full.config, n_layers=MLA_TRAIN_DEPTH,
                              microbatch=MLA_TRAIN_MICROBATCH, remat=True)
    arch = dataclasses.replace(full, config=cfg)
    return full, arch, dataclasses.replace(arch.cell("train_4k"),
                                           name=f"train_4k_b{b}",
                                           dims={"batch": b, "seq": s})


def phase_mla_train(dev):
    """Phase 31: DeepSeek-V2 trained at full width (d 5120, 128 MLA heads
    at q·k 192 / v 128, vocab 102,400; f32 master weights, bf16 compute,
    AdamW, remat) at ``MLA_TRAIN_DEPTH`` layer: (a) one step's loss and
    per-leaf gradients at ``MLA_GRAD_ROWS`` × 4096 through kernels 8 and
    8b on "mma" against the plain attention in bf16, each held to the
    plain attention's f32 gradient (phase 23's contract); (b)
    ``MLA_TRAIN_STEPS`` ``build_step`` train steps at ``MLA_TRAIN_SHAPE``
    with the launch counts zeroed before and read after, the peak over
    them beside the dry run's estimate, the warm step's seconds and
    tokens/s; (c) every forward launch on "mma"'s <192, 128> tile and
    every backward launch on "mma", none on "simt"; then one more step
    under ``torch.profiler`` (the steps are 12.9 s each: no extra warm
    call)."""
    import dataclasses

    from repro_torch.data.batches import lm_batch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.launch.dryrun import estimate
    from repro_torch.launch.steps import build_step
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tx
    from repro_torch.training.train_loop import take_grads, trainable

    b, s = MLA_TRAIN_SHAPE
    mb = MLA_TRAIN_MICROBATCH
    full, arch, cell = mla_train_cell()
    cfg = arch.config
    n_dense, n_moe = cfg.layer_counts()
    check(n_moe == 0, f"phase 31 trains dense layers only: {n_dense}, "
                      f"{n_moe}")
    out = {"reduced": [
        f"n_layers {full.config.n_layers} -> {cfg.n_layers} (the first, "
        f"dense; the MoE layers wait for a mesh)",
        f"train_4k batch {full.cell('train_4k').dims['batch']} -> {b} ({mb}"
        f" µbatches of {b // mb})", f"{MLA_TRAIN_STEPS} steps",
        f"(a) at {MLA_GRAD_ROWS} x {s}"],
        "full_params": full.config.param_count()}
    t0 = time.perf_counter()
    out["estimated_peak"] = estimate(arch, cell)["memory"]["peak_bytes"]
    out["estimate_s"] = time.perf_counter() - t0
    plan = build_step(arch, cell)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = tx.Transformer(cfg, tx.init_params(cfg, gen))
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params"] = cm.count_params(model)
    check(out["params"] == cfg.param_count(), "parameter count")

    # (a) one step's loss and gradients on the same weights and batch:
    # bf16 compute through the kernels and through the plain attention,
    # each against the plain attention's f32 gradient
    tree = trainable(model.tree())
    one = {k: torch.from_numpy(v).to(dev) for k, v in
           lm_batch(MLA_GRAD_ROWS, s, cfg.vocab, seed=31).items()}
    cfg1 = dataclasses.replace(cfg, microbatch=1)

    def grads_of(c, use_kernel):
        t0 = time.perf_counter()
        loss = float(tx.backward(c, tree, one, use_kernel=use_kernel))
        grads = take_grads(tree)
        torch.cuda.synchronize()
        return loss, grads, time.perf_counter() - t0

    lt, gt, out["grad_s_f32_plain"] = grads_of(
        dataclasses.replace(cfg1, dtype=torch.float32), False)
    fwd0, bwd0 = dict(flash_attention.routes), dict(flash_attention_bwd.routes)
    lk, gk, out["grad_s_kernel"] = grads_of(cfg1, True)
    out["grad_routes"] = {
        "forward": {r: flash_attention.routes[r] - fwd0[r] for r in fwd0},
        "backward": {r: flash_attention_bwd.routes[r] - bwd0[r]
                     for r in bwd0}}
    check(out["grad_routes"]["backward"] == {"simt": 0, "mma": 1}
          and out["grad_routes"]["forward"]["mma"] == 2,
          f"(a): the kernel path's launches {out['grad_routes']}")
    lp, gp, out["grad_s_plain"] = grads_of(cfg1, False)
    out["f32_loss"] = lt
    out["loss_kernel"], out["loss_plain"] = lk, lp
    out["loss_rel"] = abs(lk - lp) / abs(lp)
    out["grad_rel"] = grad_readings(gk, gp)
    out["kernel_vs_f32"] = grad_readings(gk, gt)
    out["plain_vs_f32"] = grad_readings(gp, gt)
    del gk, gp, gt
    check(math.isfinite(lk) and out["loss_rel"] <= 1e-3,
          f"loss kernel {lk} vs plain {lp}: {out['loss_rel']} relative")
    check(all(k <= 1.5 * p + 1e-5 for k, p in zip(out["kernel_vs_f32"],
                                                  out["plain_vs_f32"])),
          f"bf16: the kernel path's per-leaf distance to the f32 gradient "
          f"{out['kernel_vs_f32']} ≤ 1.5 × the plain path's + 1e-5 "
          f"{out['plain_vs_f32']}")

    # (b) build_step's train steps, the counts zeroed before, read after
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                lm_batch(b, s, cfg.vocab, seed=i).items()}
               for i in range(MLA_TRAIN_STEPS)]
    state = plan.optimizer.init(model.tree())
    zero_counts()
    flash_attention.routes.update(dict.fromkeys(flash_attention.routes, 0))
    flash_attention.tiles.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for batch in batches:
        t0 = time.perf_counter()
        model, state, loss = plan.fn(model, state, batch)
        losses.append(float(loss))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out["losses"], out["walls"] = losses, walls
    out["warm_s"] = float(np.mean(walls[1:]))
    out["tokens_per_s"] = b * s / out["warm_s"]
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["peak_gib"] = out["peak_bytes"] / 2**30
    out["launches"] = {"forward": flash_attention.launches,
                       "backward": flash_attention_bwd.launches}
    out["routes"] = {"forward": dict(flash_attention.routes),
                     "tiles": dict(flash_attention.tiles),
                     "backward": dict(flash_attention_bwd.routes)}
    per_step = cfg.n_layers * mb
    n_fwd, n_bwd = 2 * per_step * MLA_TRAIN_STEPS, per_step * MLA_TRAIN_STEPS
    check(all(math.isfinite(x) for x in losses), f"finite losses {losses}")
    check(int(state["step"]) == MLA_TRAIN_STEPS, "optimizer step count")
    check(out["peak_bytes"] <= MLA_PEAK_LIMIT,
          f"peak {out['peak_bytes']} B ≤ {MLA_PEAK_LIMIT}")
    # (c) the routes of the path: the forward (and its remat recompute) on
    # the <192, 128> tile, the backward on "mma", nothing on "simt"
    check(out["launches"] == {"forward": n_fwd, "backward": n_bwd},
          f"forward, remat recompute and backward launches: "
          f"{out['launches']}")
    check(out["routes"]["forward"]["mma"] == n_fwd
          and out["routes"]["tiles"] == {"192x128": n_fwd},
          f"every forward launch on \"mma\"'s <192, 128> tile: "
          f"{out['routes']}")
    check(out["routes"]["backward"] == {"simt": 0, "mma": n_bwd},
          f"every backward launch on \"mma\", none on \"simt\": "
          f"{out['routes']['backward']}")
    out["profile"] = profile_each(((
        f"DeepSeek-V2 train step ({b} x {s}, {mb} µbatches, "
        f"{cfg.n_layers} layer)", lambda: plan.fn(model, state, batches[0]),
        10),), warm=False)[0]
    del model, state, tree, batches, one
    torch.cuda.synchronize()
    return out


def log_mla_train(dt, card) -> None:
    """Phase 31's lines."""
    log(f"    {dt['params']} parameters (the uncut model "
        f"{dt['full_params']}); reduced: {dt['reduced']}; init on the card "
        f"{dt['init_s']:.2f}s")
    log(f"    (a) one step at {MLA_GRAD_ROWS} x {MLA_TRAIN_SHAPE[1]}, bf16 "
        f"compute: loss {dt['loss_kernel']!r} vs {dt['loss_plain']!r} "
        f"({dt['loss_rel']!r} relative, limit 1e-3; f32 plain "
        f"{dt['f32_loss']!r}); per-leaf ‖Δg‖/‖g‖ kernel vs plain "
        f"{[round(x, 6) for x in dt['grad_rel']]}; to the f32 gradient: "
        f"kernel {[round(x, 6) for x in dt['kernel_vs_f32']]}, plain "
        f"{[round(x, 6) for x in dt['plain_vs_f32']]} (limit 1.5 × plain's "
        f"+ 1e-5); gradient walls kernel {dt['grad_s_kernel']:.3f}s, plain "
        f"{dt['grad_s_plain']:.3f}s, f32 plain {dt['grad_s_f32_plain']:.3f}"
        f"s; the kernel path's launches by route {dt['grad_routes']}")
    log(f"    (b) losses {dt['losses']}; step walls "
        f"{[round(x, 4) for x in dt['walls']]} s, warm step "
        f"{dt['warm_s']:.4f}s ({dt['tokens_per_s']:.1f} tokens/s); peak "
        f"device memory {dt['peak_bytes']} B ({dt['peak_gib']:.2f} GiB, "
        f"limit {MLA_PEAK_LIMIT:.0f} B; the dry run's estimate "
        f"{dt['estimated_peak'] / 2**30:.2f} GiB, ratio "
        f"{dt['estimated_peak'] / dt['peak_bytes']!r}, counted in "
        f"{dt['estimate_s']:.1f}s) on {card}")
    log(f"    (c) launches {dt['launches']}; by route {dt['routes']}; phase "
        f"wall {dt['wall_s']:.1f}s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs a CUDA card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (pins TF32 off)
    from repro_torch.data import load_ml1m_synthetic
    from repro_torch.kernels import _build

    dev = torch.device(DEVICE)
    card = nvidia_smi()
    log(f"[1] card: {card}")
    log(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    # phase 25's earlier designs of kernels 8 and 8b, compiled beside the
    # shipped kernels
    builder = concurrent.futures.ThreadPoolExecutor(1)
    previous_build = builder.submit(_build.build_variants,
                                    PREVIOUS_MLA_DESIGN)
    builder.shutdown(wait=False)
    per_kernel = _build.build()
    build_s = time.perf_counter() - t0
    log(f"    kernel build {build_s:.2f}s (parallel nvcc: "
        f"{ {k: round(v, 2) for k, v in per_kernel.items()} })")
    for name in _build.KERNELS:
        report = _build.library_path(name).with_suffix(".log").read_text()
        for fn, regs, spill in _build.ptxas_report(report):
            log(f"    ptxas {name}: {fn}: {regs} registers, {spill} bytes "
                f"spill stores")

    t0 = time.perf_counter()
    train, test, spec = load_ml1m_synthetic()
    log(f"    data: ML-1M surrogate {train.shape}, "
        f"{int((train > 0).sum())} training ratings, "
        f"{int((test > 0).sum())} held out ({time.perf_counter() - t0:.1f}s)")
    train_dev = torch.from_numpy(train).to(dev)

    log("[2] kernels vs plain versions on the card")
    err = phase_kernels(dev, np.random.default_rng(0), train_dev)
    log(f"    ok: max_abs_diff similarity={err['similarity']!r} "
        f"predict={err['predict']!r} (tolerance {TOL})")

    log("[3] main path: CFEngine(kernel) fit -> recommend -> update -> serve")
    torch.cuda.reset_peak_memory_stats()
    main_out, eng = phase_main_path(dev, train, test)
    log(f"    fit {main_out['fit_s']:.3f}s, predict+MAE "
        f"{main_out['predict_s']:.3f}s, recommend(all, n=10) "
        f"{main_out['recommend_s']:.3f}s, update(16 users, oracle) "
        f"{main_out['update_s']:.3f}s")
    log(f"    serving: 512 requests, {main_out['serve_req_per_s']:.1f} req/s, "
        f"p50 {main_out['p50_ms']:.2f} ms, p99 {main_out['p99_ms']:.2f} ms, "
        f"{main_out['batches']} batches")
    log(f"    launches on the main path: {main_out['launches']}; "
        f"similarity by route {main_out['routes']} (the fit alone "
        f"{main_out['fit_routes']}); tile predict by route "
        f"{main_out['predict_routes']}")
    log(f"    exact fit: wall {main_out['fit_s']:.4f} s (first fit); a "
        f"steady fit {main_out['fit_profile'][0]:.2f} ms wall, "
        f"{main_out['fit_profile'][1]:.2f} ms device busy")
    log(f"    held-out MAE {main_out['mae']!r}; kernel backend == "
        f"sequential backend (ids, scores, predict(), top-n) at "
        f"{train.shape[0]}x{train.shape[1]}")
    log(f"    peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    small_e = phase_small_cross_check(dev)
    log(f"    small input (384x300): CPU plain path == card kernels "
        f"(ids equal, score diff {small_e!r})")

    log("[4] index kernels vs plain versions on the card")
    ierr = phase_index_kernels(dev, np.random.default_rng(1), train_dev)
    log(f"    ok: max_abs_diff {ierr} (tolerance {TOL})")

    log("[5] approx path: CFEngine(neighbor_mode='approx', kernel) fit -> "
        "recall -> cluster query -> update -> serve")
    torch.cuda.reset_peak_memory_stats()
    ap, eng_ap = phase_approx(dev, train)
    q = ap["query"]
    log(f"    index {ap['config']}")
    log(f"    fit+query {ap['fit_s']:.3f}s (plain versions on the card "
        f"{ap['plain_fit_s']:.3f}s); last_query: scan {q['scan_mode']}, "
        f"rerank_fraction {q['rerank_fraction']!r}, shortlist "
        f"{q['seconds_shortlist']:.4f}s, rerank {q['seconds_rerank']:.4f}s, "
        f"total {q['seconds_total']:.4f}s")
    log(f"    recall_vs_exact(sample=1024) {ap['recall']!r} "
        f"({ap['recall_s']:.3f}s)")
    log(f"    cluster-restricted query (n_probe 4, 1024 users): "
        f"{ap['cluster_query']}")
    log(f"    update(16 users, oracle) {ap['update_s']:.3f}s, refold "
        f"{ap['refold']}")
    log(f"    serving: 256 requests, {ap['serve_req_per_s']:.1f} req/s, "
        f"p50 {ap['p50_ms']:.2f} ms, p99 {ap['p99_ms']:.2f} ms")
    log(f"    launches on the approx path: {ap['launches']}; rerank by "
        f"route {ap['rerank_routes']}")
    sg = ap["staged"]
    log(f"    staged query (query_mode_override='staged', 6040 users): "
        f"{sg['staged_s']:.4f}s (shortlist / rerank stages "
        f"{sg['staged_split_s'][0]:.4f} / {sg['staged_split_s'][1]:.4f}s), "
        f"fused {sg['fused_s']:.4f}s on {card}; "
        f"ids and scores bit for bit; launches on the staged path "
        f"{sg['launches']}, rerank by route {sg['rerank_routes']}")
    log("    kernel == plain versions (spill ids/dist, centroids, proxies, "
        "shortlists, neighbor ids and scores, cluster query) and two fits "
        "identical")
    log(f"    peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    log("[6] scale: index vs exact at U=32768 (cosine, k=20, raw, "
        "project_dim 512, rerank_frac 0.02)")
    sc = phase_scale(dev)
    log(f"    data {sc['data_s']:.1f}s ({sc['ratings']} ratings), C="
        f"{sc['n_clusters']} n_probe={sc['n_probe']}; index fit "
        f"{sc['fit_s']:.3f}s, query {sc['query_s']:.3f}s {sc['query']}; "
        f"exact kernel top-k {sc['exact_s']:.3f}s")
    log(f"    recall@20 {sc['recall']!r} (floor 0.94); peak device memory "
        f"{sc['peak_gib']:.2f} GiB (index fit + query); rerank by route "
        f"{sc['rerank_routes']}")
    sg = sc["staged"]
    log(f"    staged query: recall@20 {sg['recall']!r}, {sg['staged_s']:.4f}s"
        f" (shortlist / rerank stages {sg['staged_split_s'][0]:.4f} / "
        f"{sg['staged_split_s'][1]:.4f}s; fused {sg['fused_s']:.4f}s) on "
        f"{card}; ids and scores == fused "
        f"bit for bit; launches on the staged path {sg['launches']}, "
        f"rerank by route {sg['rerank_routes']}")

    log("[7] support kernel vs plain version on the card; support score "
        "== exact prediction")
    serr = phase_support_kernel(dev, np.random.default_rng(2), eng)
    log(f"    ok: max_abs_diff support={serr!r} (0.0 required)")

    log("[8] approx recommend: CFEngine(recommend_mode='approx') fit -> "
        "recommend -> recall -> update -> serve")
    torch.cuda.reset_peak_memory_stats()
    rc, eng_rec = phase_recommend(dev, train)
    log(f"    item index {rc['config']}")
    log(f"    fit (exact neighbors + item index) {rc['fit_s']:.3f}s (item "
        f"index on the plain versions: engine fit {rc['plain_fit_s']:.3f}s)")
    log(f"    recommend(all, n=10): approx {rc['approx_s']:.4f}s (rerank "
        f"fraction {rc['rerank_fraction']!r}), shortlist 64 "
        f"{rc['approx64_s']:.4f}s, exact {rc['exact_s']:.4f}s, plain "
        f"versions {rc['plain_approx_s']:.4f}s; approx == exact bitwise "
        f"at shortlist 512 and 64")
    log(f"    recommend_recall_vs_exact(sample=256) {rc['recall']!r} "
        f"({rc['recall_s']:.3f}s)")
    log(f"    update(16 users, oracle incl. item index) "
        f"{rc['update_s']:.3f}s, item refold {rc['refold']}")
    log(f"    serving: 256 requests, {rc['serve_req_per_s']:.1f} req/s, p50 "
        f"{rc['p50_ms']:.2f} ms, p99 {rc['p99_ms']:.2f} ms, health "
        f"{rc['health']}; no served item was already rated")
    log(f"    launches on the approx-recommend path: {rc['launches']}; "
        f"support by route {rc['support_routes']}")
    log(f"    peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    log("[9] recommend at U=32768 (BENCH_recommend.json "
        "recommend_cosine_U32768: cosine, k=40, approx neighbors, "
        "shortlist 64)")
    rs = phase_recommend_scale(dev, sc.pop("matrix"))
    log(f"    engine fit {rs['fit_s']:.3f}s (item index alone "
        f"{rs['item_fit_s']:.3f}s, C={rs['n_item_clusters']}); "
        f"recommend(all, n=10) exact {rs['exact_s']:.3f}s, approx "
        f"{rs['approx_s']:.3f}s (rerank fraction "
        f"{rs['rerank_fraction']!r})")
    log(f"    recall@10 {rs['recall']!r} (the reference's 1.0); approx == "
        f"exact bitwise: {rs['bitwise']}; peak device memory "
        f"{rs['peak_gib']:.2f} GiB")

    log("[10] flash-attention kernel vs plain version on the card")
    ferr = phase_flash_kernel(dev)

    log("[11] LM serving: Llama-3.2-1B at full width, build_step prefill "
        "(4 x 2048, max_len 2080) -> 16 greedy decode steps")
    lm = phase_lm(dev)
    log(f"    {lm['params']} parameters, init on the card "
        f"{lm['init_s']:.2f}s")
    log(f"    prefill {lm['prefill_s']:.4f}s "
        f"({4 * 2048 / lm['prefill_s']:.1f} prompt tokens/s); decode "
        f"{lm['decode_ms_per_token']:.3f} ms/step (4 rows), "
        f"{lm['tokens_per_s']:.1f} generated tokens/s; peak device memory "
        f"{lm['peak_gib']:.2f} GiB; cache len 2064")
    log(f"    flash launches on the LM path: {lm['launches']}; by route "
        f"{lm['routes']}")
    log(f"    layer-0 prefill q/k/v: kernel vs plain max_abs_diff "
        f"{lm['layer0_err']!r} (bf16, tolerance 2e-2 and one bf16 ulp + "
        f"1e-5), {lm['layer0_err_f32']!r} (f32 copies, tolerance 1e-5)")
    log(f"    kernel vs plain attention, teacher-forced: max |logit diff| "
        f"{lm['max_logit_diff']!r} (per step "
        f"{[round(x, 5) for x in lm['logit_diffs']]}); argmax agrees on "
        f"{lm['argmax'][0]} of {lm['argmax'][1]} rows with top-2 margin "
        f"> 0.05")

    log("[12] kernel timings at the main paths' shapes (CUDA events)")
    kernels = phase_timings(dev, eng, err, main_out["launches"])
    kernels += phase_index_timings(dev, eng_ap, ierr, ap["launches"])
    kernels += phase_support_timings(dev, eng_rec, serr, rc["launches"])
    flash_row, flash_dec = phase_flash_timings(lm, ferr[torch.bfloat16])
    kernels.append(flash_row)
    sel_item = phase_select_item_timing(dev, eng_rec)
    for k in kernels:
        log(f"    {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, "
            f"library {k['library_ms']}, bound {k['bound_ms']:.4f} ms by "
            f"{k['bound_by']}) at {k['shape']}")
    log(f"    flash_attention decode launch (Sq=1, kv_len 2049, B=4, "
        f"Hq=32, Hkv=8, d=64, bf16): {flash_dec['ms']:.4f} ms on the device "
        f"(the call, host included, {flash_dec['call_ms']:.4f}; plain "
        f"{flash_dec['plain_ms']:.4f}, library "
        f"{flash_dec['library_ms']:.4f}, bound {flash_dec['bound_ms']:.4f} "
        f"ms by {flash_dec['bound_by']}), max_abs_diff "
        f"{flash_dec['max_abs_err']!r} (bf16), "
        f"{flash_dec['max_abs_err_f32']!r} (f32 copies)")
    log(f"    select_topm at the item index's shape ({sel_item['shape']}): "
        f"{sel_item['ms']:.4f} ms on the device (the call, host included, "
        f"{sel_item['call_ms']:.4f}; plain {sel_item['plain_ms']:.4f}, "
        f"library {sel_item['library_ms']:.4f}, bound "
        f"{sel_item['bound_ms']:.4f} ms by {sel_item['bound_by']}), ids "
        f"and values bit for bit")
    sel_row = next(k for k in kernels if k["name"] == "select_topm")
    log(f"    select_topm at the cluster query's shape: the call, host "
        f"included, {sel_row['call_ms']:.4f} ms")
    scan_row = next(k for k in kernels if k["name"] == "fused_scan_topm")
    sp = scan_row["split"]
    log(f"    fused_scan_topm's two launches alone: scores "
        f"{sp['scores_ms']:.4f} ms (the pinned order's no-FMA floor "
        f"{sp['floor_ms']:.4f} ms at 1.98 GHz), radix select "
        f"{sp['select_ms']:.4f} ms")
    sim_row = kernels[0]
    log(f"    fused_similarity: int8 route {sim_row['ms']:.4f} ms (bound "
        f"{sim_row['bound_ms']:.4f} ms at the int8 peak), six "
        f"torch._int_mm {sim_row['int_mm_ms']:.4f} ms, six torch.matmul "
        f"{sim_row['library_ms']:.4f} ms; simt route (f32 rows, the "
        f"previous design) {sim_row['simt_ms']:.4f} ms (bound "
        f"{sim_row['f32_bound_ms']:.4f} ms at the f32 peak); both bit for "
        f"bit")
    sup_row = next(k for k in kernels if k["name"] == "fused_support_scores")
    log(f"    fused_support_scores: int8 route {sup_row['ms']:.4f} ms "
        f"(bound {sup_row['bound_ms']:.4f} ms by {sup_row['bound_by']}; "
        f"the pinned order's no-FMA floor {sup_row['nofma_floor_ms']:.4f} "
        f"ms), table route (the previous design) {sup_row['table_ms']:.4f} "
        f"ms (bytes bound of its tables {sup_row['table_bound_ms']:.4f} "
        f"ms), torch.sparse.mm {sup_row['library_ms']:.4f} ms; both bit "
        f"for bit")
    rr_row = next(k for k in kernels if k["name"] == "fused_rerank_scores")
    int_mm = rr_row["int_mm_ms"]
    log(f"    fused_rerank_scores: int8 route {rr_row['ms']:.4f} ms (bound "
        f"{rr_row['bound_ms']:.4f} ms at the int8 peak over the real "
        f"columns), six torch._int_mm "
        f"{int_mm if isinstance(int_mm, str) else f'{int_mm:.4f} ms'}; "
        f"simt route (f32 queries) {rr_row['simt_ms']:.4f} ms (bound "
        f"{rr_row['simt_bound_ms']:.4f} ms at the f32 peak); both bit for "
        f"bit")
    pred_row = next(k for k in kernels if k["name"] == "fused_tile_predict")
    log(f"    fused_tile_predict: one whole-range launch {pred_row['ms']:.4f} "
        f"ms on the device (the call, host included, "
        f"{pred_row['call_ms']:.4f}; one 512-item tile "
        f"{pred_row['tile_ms']:.4f}, the call {pred_row['tile_call_ms']:.4f}"
        f"), torch.sparse.mm {pred_row['library_ms']:.4f} ms, bound "
        f"{pred_row['bound_ms']:.4f} ms by {pred_row['bound_by']}, the "
        f"pinned order's no-FMA floor {pred_row['nofma_floor_ms']:.4f} ms; "
        f"bit for bit")
    dist_row = next(k for k in kernels
                    if k["name"] == "fused_centroid_distances")
    log(f"    fused_centroid_distances: {dist_row['ms']:.4f} ms on the "
        f"device (the call, host included, {dist_row['call_ms']:.4f}), "
        f"torch.cdist().square() {dist_row['library_ms']:.4f} ms, bound "
        f"{dist_row['bound_ms']:.4f} ms, the cross term's no-FMA floor "
        f"{dist_row['nofma_floor_ms']:.4f} ms; bit for bit")
    now = {"fused_tile_predict m=1024 k=40 [0,3952)": pred_row["ms"],
           "fused_centroid_distances (6040,256)x(78,256)": dist_row["ms"],
           "select_topm Q=256 L=8192 m=906": sel_row["ms"],
           "select_topm Q=6040 L=3952 m=512": sel_item["ms"],
           "flash_attention prefill": flash_row["ms"],
           "flash_attention decode": flash_dec["ms"],
           "fused_scan_topm Q=2048 N=6040 P=256 m=906": scan_row["ms"],
           "fused_rerank_scores G=2048 J=3952 pcc": rr_row["ms"]}
    log("    kernels 2, 3, 4, 5, 6 and 8, previous design -> this design "
        "(ms): "
        + "; ".join(f"{k} {PREVIOUS_MS[k]} -> {now[k]:.4f}" for k in now))
    log("[13] torch.profiler: device time of a steady fit / recommend / "
        "approx query (fused, staged) / approx recommend / LM prefill / LM "
        "decode step")
    phase_profile(eng, eng_ap, eng_rec, lm)
    # the CF engines and the LM leave the card to the DLRM tables
    del eng, eng_ap, eng_rec, lm, train_dev
    gc.collect()
    torch.cuda.empty_cache()

    log("[14] embedding-bag kernel vs plain version on the card")
    berr, bcases, broutes = phase_bag_kernel(dev)
    log(f"    ok: {bcases} cases, max_abs_diff={berr!r} (0.0 required); "
        f"launches by route {broutes}; the check launch's and the bag "
        f"launch's counts of ids past the table == the plain count, and "
        f"the wrapper raises on them")

    log(f"[15] DLRM-MLPerf at published widths (fields capped at "
        f"{DLRM_ROW_CAP} rows): build_step serve_p99 / serve_bulk / "
        f"retrieval")
    dl = phase_dlrm(dev)
    log(f"    reduced: {dl['reduced']}; {dl['rows']} table rows, "
        f"{dl['params']} parameters ({dl['table_gib']:.2f} GiB f32; the "
        f"uncut model {dl['full_params']}), init on the card "
        f"{dl['init_s']:.2f}s")
    log_serving("DLRM", dl)
    log(f"    retrieval == forward on the substituted batch: max_abs_diff "
        f"{dl['ret_vs_fwd']!r}; peak device memory {dl['peak_gib']:.2f} GiB")
    log(f"    {dl['l1_bags'][0]} L = 1 bags (serve_p99's sharded-field ids) "
        f"through ops.embedding_bag == the step's lookups bit for bit; "
        f"multi-hot {BAG_SHAPE} sum / mean: kernel == plain "
        f"(max_abs_diff {dl['bag_err']!r}); embedding_bag launches "
        f"{dl['launches']} by route {dl['routes']}")

    log("[16] embedding-bag timing (CUDA events) and DLRM profile")
    bag_row = phase_bag_timings(dl, max(berr, dl["bag_err"]))
    kernels.append(bag_row)
    for sh in bag_row["shapes"]:
        line = (f"    embedding_bag {sh['name']}: launch {sh['ms']:.4f} ms "
                f"with a cold L2 (warm, device alone, {sh['warm_ms']:.4f}; "
                f"the wrapper with its id check back to back "
                f"{sh['wrapper_ms']:.4f}, one call's host wall "
                f"{sh['wrapper_host_ms']:.4f}), plain "
                f"{sh['plain_ms']:.4f}, F.embedding_bag "
                f"{sh['library_ms']:.4f} (warm {sh['library_warm_ms']:.4f}; "
                f"diff {sh['library_diff']!r}), ")
        if "gather_ms" in sh:
            line += (f"the serve step's gather {sh['gather_ms']:.4f} (warm "
                     f"{sh['gather_warm_ms']:.4f}), ")
        log(line + f"bound {sh['bound_ms']:.4f} ms by {sh['bound_by']} at "
            f"{sh['shape']}; kernel == plain")
    serve, bulk, b_p99, b_bulk = dl["steps"]
    profile_each((("DLRM serve_p99 step", lambda: serve.fn(dl["model"],
                                                           b_p99)),
                  ("DLRM serve_bulk step", lambda: bulk.fn(dl["model"],
                                                           b_bulk))))
    # FM and xDeepFM get the card to themselves
    del dl, serve, bulk, b_p99, b_bulk
    gc.collect()
    torch.cuda.empty_cache()

    log("[17] FM and xDeepFM at full config: serve_p99 / serve_bulk / "
        "retrieval_cand")
    fx = phase_fm_xdeepfm(dev)
    bag_row["launches"] += fx.pop("bag_launches")
    bag_routes = fx.pop("bag_routes")
    log(f"    FM multi-hot {BAG_SHAPE} bags over the factor and linear "
        f"tables, sum / mean: kernel == plain (max_abs_diff "
        f"{fx.pop('bag_err')!r}); embedding_bag launches on this path by "
        f"route {bag_routes}; on the DLRM and FM paths together "
        f"{bag_row['launches']}")
    for name, out in fx.items():
        log(f"    {name}: {out['params']} parameters; reduced: "
            f"{out['reduced'] or 'none'}")
        log_serving(name, out)
        if "ret_vs_fwd" in out:
            log(f"    {name}: factorised retrieval == forward on the "
                f"substituted batch, max_abs_diff {out['ret_vs_fwd']!r} "
                f"(tolerance 1e-5)")
        log(f"    {name}: peak device memory {out['peak_gib']:.2f} GiB")

    log("[18] recsys smoke configs: CPU path vs card")
    rs_e = phase_recsys_small(dev)
    log(f"    forward and retrieval, 3 models: max_abs_diff {rs_e!r} "
        f"(tolerance 1e-5)")

    log("[19] chaos: the chaos bench's four drills on the port "
        "(serving, admission, engine recovery, DEGRADED recall)")
    ch = phase_chaos(dev)
    for name in ("serving", "admission", "engine", "degraded"):
        log(f"    {name} drill: {ch[name]}")
    log(f"    DEGRADED recall@20 {ch['degraded']['recall_at20']!r} at "
        f"U={CHAOS_RECALL_U} (floor 0.90; the reference's "
        f"{CHAOS_REF_RECALL}); phase wall {ch['wall_s']:.2f}s on {card}; "
        f"launches in the drills {ch['launches']}")

    log("[20] sharded execution on a one-rank NCCL mesh: sharded / ring "
        "engines, sharded index fit, host support scorer, sharded lookup, "
        "restore onto the mesh")
    sh = phase_sharded(dev, train)
    log(f"    {sh['mesh']}; on {card}")
    log("    walls (s): " + "; ".join(f"{k} {v:.4f}"
                                      for k, v in sh["walls"].items()))
    log(f"    launches: {sh['launches']}")
    log(f"    sharded / ring predict vs predict(): max_abs_diff "
        f"{sh['predict_err']!r} (tolerance 1e-5); sharded lookup "
        f"{sh['lookup']} bit for bit; {sh['restored_leaves']} leaves "
        f"restored onto the mesh bit for bit")
    for k in kernels:
        k["launches"] += sh["kernel_launches"].get(k["name"], 0)

    log("[21] the paper's pipeline through the legacy path: UserCF "
        "(sequential, sharded, ring), the Figs. 3-6 sweep, the legacy "
        "server, Slope One, the cf_movielens steps")
    lg = phase_legacy(dev, train, test)
    ev = lg["evaluate"]
    log(f"    UserCF sequential fit at {train.shape[0]}x{train.shape[1]}: "
        f"{lg['fit_s']:.4f}s (first), {lg['fit_warm_s']:.4f}s (again) on "
        f"{card}; == CFEngine(kernel) bit for bit; predict == plain "
        f"blocked predict bit for bit")
    log("    evaluate: " + ", ".join(f"{k} {ev[k]!r}" for k in (
        "mae", "rmse", "precision", "recall", "f1", "top10_precision",
        "top10_recall", "top10_f1")))
    log(f"    Figs. 3-6 vs BENCH_topk.json ({TOPK_FIG_SIZE[0]}x"
        f"{TOPK_FIG_SIZE[1]}, 15 fits): max |diff| {lg['figs_err']} "
        f"(tolerance {TOL})")
    for name, row in lg["figs"].items():
        log(f"      {name}: " + ", ".join(f"{k} {v!r}"
                                         for k, v in row.items()))
    for name in ("legacy", "facade"):
        sv = lg[f"{name}_serving"]
        log(f"    {name} server: 512 requests, {sv['req_per_s']:.1f} req/s, "
            f"p50 {sv['p50_ms']:.2f} ms, p99 {sv['p99_ms']:.2f} ms, "
            f"{sv['batches']} batches")
    log(f"    legacy ids == facade ids == UserCF.recommend; sharded fit "
        f"{lg['sharded_fit_s']:.4f}s, ring fit {lg['ring_fit_s']:.4f}s, "
        f"both == sequential bit for bit")
    log(f"    Slope One: deviations card == CPU == sharded bit for bit at "
        f"{train.shape[0]}x{train.shape[1]}; predict card vs CPU (384x300) "
        f"{lg['slope_small_err']!r}; fit + evaluate {lg['slope_s']:.4f}s: "
        f"MAE {lg['slope_eval']['mae']!r}, RMSE {lg['slope_eval']['rmse']!r}"
        f", precision {lg['slope_eval']['precision']!r}, recall "
        f"{lg['slope_eval']['recall']!r}")
    log(f"    cf_movielens fit_ml1m at {lg['step_shape']}: ring step == "
        f"UserCF sequential bit for bit; cf_predict step vs UserCF.predict "
        f"{lg['step_predict_err']!r} (tolerance 1e-5)")
    for name, line in lg["unrun"].items():
        log(f"    reduced: {name} plan only — {line}")
    log("    walls (s): " + "; ".join(f"{k} {v:.4f}"
                                      for k, v in lg["walls"].items()))
    log(f"    launches: {lg['launches']}")
    for k in kernels:
        k["launches"] += lg["kernel_launches"].get(k["name"], 0)

    # the training slice gets the card to itself
    del sh, lg
    gc.collect()
    torch.cuda.empty_cache()

    log("[22] flash-attention backward kernel vs plain version on the "
        "card; timing at Llama-3.2-1B's prefill shapes")
    t_phase = time.perf_counter()
    fb = phase_flash_bwd(dev)
    fb["wall_s"] = time.perf_counter() - t_phase
    log(f"    dQ, dK, dV vs the plain backward (max abs diff, relative to "
        f"the largest |grad|): {fb['errs']} (tolerance "
        f"{ {str(k)[6:]: v for k, v in BWD_TOL.items()} } relative)")
    log(f"    two calls bitwise equal on both routes; the forward's lse vs "
        f"plain (max abs diff, limits "
        f"{ {str(k)[6:]: v for k, v in LSE_TOL.items()} }): {fb['lse_errs']}")
    log(f"    flash_attention_bwd at {fb['shape']}: {fb['ms']:.4f} ms on "
        f"\"{fb['route']}\" (f32 on \"{fb['f32_route']}\" "
        f"{fb['f32_ms']:.4f}), plain {fb['plain_ms']:.4f} ms, "
        f"scaled_dot_product_attention backward {fb['library_ms']:.4f} ms, "
        f"bound {fb['bound_ms']:.4f} ms by {fb['bound_by']} (five "
        f"products; the seven the deterministic design runs "
        f"{fb['floor7_ms']:.4f}) on {card}; phase wall {fb['wall_s']:.1f}s")
    log("    flash_attention (ms): " + "; ".join(
        f"{k} {v:.4f}" for k, v in fb["fwd"].items()))

    log(f"[23] LM training: Llama-3.2-1B at full width, train_4k cut to "
        f"{LM_TRAIN_SHAPE[0]} x {LM_TRAIN_SHAPE[1]} ({LM_TRAIN_MICROBATCH} "
        f"µbatches, remat, AdamW), {LM_TRAIN_STEPS} build_step train steps")
    t_phase = time.perf_counter()
    lt = phase_lm_train(dev)
    lt["wall_s"] = time.perf_counter() - t_phase
    log(f"    {lt['params']} parameters; reduced: {lt['reduced']}")
    log(f"    one step, kernel vs plain attention, f32 compute: loss "
        f"{lt['f32_loss']} ({lt['f32_loss_rel']!r} relative, limit 1e-3); "
        f"per-leaf ‖Δg‖/‖g‖ {[round(x, 8) for x in lt['f32_grad_rel']]} "
        f"(limit 1e-2); gradient walls kernel {lt['grad_s_f32_kernel']:.3f}"
        f"s, plain {lt['grad_s_f32_plain']:.3f}s")
    log(f"    bf16 compute (the trained config): loss {lt['loss_kernel']!r} "
        f"vs {lt['loss_plain']!r} ({lt['loss_rel']!r} relative, limit "
        f"1e-3); per-leaf ‖Δg‖/‖g‖ kernel vs plain "
        f"{[round(x, 6) for x in lt['grad_rel']]}; to the f32 gradient: "
        f"kernel {[round(x, 6) for x in lt['kernel_vs_f32']]}, plain "
        f"{[round(x, 6) for x in lt['plain_vs_f32']]} (limit 1.5 × "
        f"plain's + 1e-5); gradient walls kernel {lt['grad_s_kernel']:.3f}s, "
        f"plain {lt['grad_s_plain']:.3f}s")
    log(f"    losses {lt['losses']}; first step {lt['first_s']:.3f}s, warm "
        f"step {lt['warm_s']:.3f}s ({lt['tokens_per_s']:.1f} tokens/s); "
        f"peak device memory {lt['peak_gib']:.2f} GiB on {card}")
    log(f"    kernel 8 launches on the training path: {lt['launches']}, "
        f"the backward's by route {lt['bwd_routes']}; phase wall "
        f"{lt['wall_s']:.1f}s")

    log("[24] recsys training (DLRM, FM, xDeepFM: Adagrad; BERT4Rec: "
        "AdamW), BERT4Rec serving, the fault-tolerant train loop")
    t_phase = time.perf_counter()
    rt = phase_recsys_train(dev)
    rt["wall_s"] = time.perf_counter() - t_phase
    for name in ("dlrm_mlperf", "fm", "xdeepfm", "bert4rec"):
        o = rt[name]
        log(f"    {name}: {o['params']} parameters, {o['optimizer']}, "
            f"{o['rows']} rows a step; losses {o['losses']}, step walls "
            f"{[round(x, 4) for x in o['walls']]} s; loss on the first "
            f"batch {o['before']!r} -> {o['after']!r}; peak "
            f"{o['peak_gib']:.2f} GiB; reduced: {o['reduced'] or 'none'}")
    bo = rt["bert4rec"]
    log_serving("BERT4Rec", bo)
    log(f"    BERT4Rec retrieval == serve_scores at the candidates: "
        f"max_abs_diff {bo['ret_vs_serve']!r} (tolerance 1e-5)")
    log(f"    train loop: {rt['loop']}; phase wall {rt['wall_s']:.1f}s")

    flash_row["launches"] += lt["launches"]["forward"]
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/common.py:126",
        "launches": lt["launches"]["backward"],
        "max_abs_err": fb["max_abs_err"], "ms": fb["ms"],
        "plain_ms": fb["plain_ms"], "bound_ms": fb["bound_ms"],
        "bound_by": fb["bound_by"], "library_ms": fb["library_ms"],
        "shape": fb["shape"]})

    # the MoE / MLA LMs get the card to themselves
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[25] MoE / MLA LM serving at full width: Qwen3-30B-A3B "
        f"({MOE_LM_DEPTH['qwen3_moe_30b_a3b']} layers) and DeepSeek-V2 "
        f"({MOE_LM_DEPTH['deepseek_v2_236b']} layers), build_step prefill "
        f"({MOE_LM_SHAPE[0]} x {MOE_LM_SHAPE[1]}, max_len {MOE_LM_SHAPE[2]})"
        f" -> {MOE_LM_SHAPE[3]} greedy decode steps; smoke train steps")
    t_phase = time.perf_counter()
    mo = phase_moe_mla(dev, previous_build.result())
    mo["wall_s"] = time.perf_counter() - t_phase
    b, s, _, steps = MOE_LM_SHAPE
    for name in MOE_LM_DEPTH:
        o = mo[name]
        log(f"    {name}: {o['params']} parameters ({o['active_params']} "
            f"active a token; the uncut model {o['full_params']}), "
            f"{o['weights_gib']:.2f} GiB of weights (f32 master + bf16 "
            f"compute copy), init on the card {o['init_s']:.2f}s; reduced: "
            f"{o['reduced']}")
        log(f"    {name}: prefill {o['prefill_s']:.4f}s "
            f"({b * s / o['prefill_s']:.1f} prompt tokens/s); decode "
            f"{o['decode_ms_per_step']:.3f} ms/step ({b} rows), "
            f"{o['tokens_per_s']:.1f} generated tokens/s; peak device "
            f"memory {o['peak_gib']:.2f} GiB on {card}")
        log(f"    {name}: launches {o['launches']}; flash by route "
            f"{o['routes']}; cache len {s + steps}")
        log(f"    {name}: layer-0 q/k/v kernel vs plain max_abs_diff "
            f"{o['layer0_err']!r} (one bf16 ulp + 1e-5); the first MoE "
            f"layer with kernel 5 == with the plain selection, bit for bit")
        fr = o["free"]
        log(f"    {name}: kernels vs plain attention and selection, "
            f"teacher-forced: routed expert sets differ on "
            f"{o['routing_diff'][0]} of {o['routing_diff'][1]} (token, MoE "
            f"layer) pairs; max |logit diff| {max(fr['diffs'])!r}; argmax "
            f"agrees on {fr['agree']} of {fr['checked']} rows with top-2 "
            f"margin > 0.05; the others (step, row, margin, own token "
            f"rerouted): {fr['rows']}")
        log(f"    {name}: with the plain run's routing pinned to the kernel "
            f"run's: max |logit diff| {o['max_logit_diff']!r} (per step "
            f"{[round(x, 5) for x in o['logit_diffs']]}); argmax agrees on "
            f"{o['argmax'][0]} of {o['argmax'][1]} rows with top-2 margin "
            f"> 0.05")
    for name, o in mo["train"].items():
        log(f"    {name} smoke config, one build_step train step on the "
            f"card (f32, AdamW): loss {o['loss']!r}, {o['wall_s']:.3f}s, "
            f"launches {o['launches']}")
    mla_row, router_row, router, mla_bwd = mo["rows"]
    for name, r in router.items():
        log(f"    select_topm at the {name} router shape ({r['shape']}): "
            f"{r['ms']:.4f} ms on the device (plain {r['plain_ms']:.4f}, "
            f"torch.topk {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
            f"ms by {r['bound_by']}); ids and values bit for bit")
    log(f"    flash_attention at {mla_row['shape']}: {mla_row['ms']:.4f} ms "
        f"(the <256, 128> tile it ran on before "
        f"{mla_row['previous_ms']:.4f}; in turns, old / new / new / old "
        f"{[round(x, 4) for x in mla_row['turns']]}; that tile's max_abs_diff"
        f" {mla_row['previous_err']!r}), plain {mla_row['plain_ms']:.4f}, "
        f"scaled_dot_product_attention {mla_row['library_ms']:.4f}, bound "
        f"{mla_row['bound_ms']:.4f} ms by {mla_row['bound_by']} on {card}")
    log(f"    flash_attention_bwd at MLA width ({mla_bwd['shape']}): "
        f"{mla_bwd['ms']:.4f} ms (the \"simt\" route it took before "
        f"{mla_bwd['previous_ms']:.4f}; in turns, old / new / new / old "
        f"{[round(x, 4) for x in mla_bwd['turns']]}), plain "
        f"{mla_bwd['plain_ms']:.4f}, scaled_dot_product_attention backward "
        f"{mla_bwd['library_ms']:.4f}, bound {mla_bwd['bound_ms']:.4f} ms by "
        f"{mla_bwd['bound_by']}; dQ, dK, dV within {mla_bwd['rel_err']!r} "
        f"of the largest |grad| (limit {BWD_TOL[torch.bfloat16]}; the d = 64 "
        f"route's reading {MLA_BWD_REL_READING}; \"simt\" "
        f"{mla_bwd['previous_rel']!r}) on {card}")
    log(f"    phase wall {mo['wall_s']:.1f}s")
    flash_row["launches"] += (
        mo["qwen3_moe_30b_a3b"]["launches"]["flash prefill"]
        + mo["qwen3_moe_30b_a3b"]["launches"]["flash decode"])
    kernels += [mla_row, router_row, mla_bwd]

    # the model-parallel step gets the card to itself
    del mo
    gc.collect()
    torch.cuda.empty_cache()
    log("[26] the model-parallel train step on a one-rank NCCL mesh "
        "(data 1 x model 1): Llama-3.2-1B, the MoE LMs' sharded branch, "
        "the MoE smoke steps, the recsys steps and DLRM serve_p99, each "
        "against its no-mesh twin")
    t_phase = time.perf_counter()
    mt = phase_mesh_train(dev)
    mt["wall_s"] = time.perf_counter() - t_phase
    a = mt["llama"]
    log(f"    {mt['mesh']} on {card}")
    log(f"    Llama-3.2-1B ({LM_TRAIN_SHAPE[0]} x {LM_TRAIN_SHAPE[1]}, "
        f"{LM_TRAIN_MICROBATCH} µbatches, remat, bf16 compute): loss mesh "
        f"vs no mesh {a['loss']} ({a['loss_rel']!r} relative, limit 1e-3); "
        f"per-leaf ‖Δg‖/‖g‖ max {max(a['grad_rel'])!r} (limit 1e-2); "
        f"bitwise {a['bitwise']}; gradient launches (kernel 8, 8b) "
        f"{a['grad_launches']}")
    for key in ("plain", "mesh"):
        st = a[f"{key}_step"]
        log(f"    Llama build_step train step, {key}: loss {st['losses']}, "
            f"wall {st['walls'][0]:.4f} s, peak {st['peak_gib']:.2f} GiB, "
            f"launches {st['launches']} on {card}")
    for name, o in mt["moe"].items():
        log(f"    {name} ({o['reduced']}): loss sharded branch vs unsharded "
            f"{o['loss']} ({o['loss_rel']!r} relative, limit 1e-3), bitwise "
            f"{o['bitwise']}; expert ids equal on all {o['pairs']} (token, "
            f"layer) rows: {o['ids_equal']}; walls (s) {o['walls']}; "
            f"launches {o['launches']}")
    for name, o in mt["moe_smoke"].items():
        log(f"    {name} smoke, 2 AdamW steps (f32, \"simt\"): losses mesh / "
            f"no mesh {o['losses']}; params max |diff| {o['param_err']!r} "
            f"(limit 1e-5); launches {o['launches']}")
    for name, o in mt["recsys"].items():
        log(f"    {name}: {RECSYS_TRAIN_STEPS} {o['optimizer']} steps of "
            f"{o['rows']} rows, losses mesh / no mesh {o['losses']} (max "
            f"{max(o['loss_rel'])!r} relative, limit 1e-5); step walls (s) "
            f"mesh {[round(x, 4) for x in o['walls']['mesh']]}, no mesh "
            f"{[round(x, 4) for x in o['walls']['plain']]}; peak GiB "
            f"{ {k: round(v, 2) for k, v in o['peak_gib'].items()} }")
        if o["serve"]:
            log(f"    {name} serve_p99 through the mesh step: max |diff| "
                f"{o['serve']['err']!r} (0.0 required), {o['serve']['wall_s']:.4f}"
                f" s, out placements {o['serve']['placements']}")
    log(f"    phase wall {mt['wall_s']:.1f}s")
    n8 = (a["grad_launches"]["mesh"][0] + a["mesh_step"]["launches"]["flash"]
          + sum(o["launches"]["mesh"]["flash"] for o in mt["moe"].values())
          + sum(o["launches"]["flash"] for o in mt["moe_smoke"].values()))
    n8b = (a["grad_launches"]["mesh"][1]
           + a["mesh_step"]["launches"]["flash_bwd"]
           + sum(o["launches"]["flash_bwd"]
                 for o in mt["moe_smoke"].values()))
    n5 = (sum(o["launches"]["mesh"]["select"] for o in mt["moe"].values())
          + sum(o["launches"]["select"] for o in mt["moe_smoke"].values()))
    check(n8 > 0 and n8b > 0 and n5 > 0,
          f"phase 26 launches: kernel 8 {n8}, 8b {n8b}, 5 {n5}")
    log(f"    launches on the mesh paths: kernel 8 {n8}, 8b {n8b}, "
        f"kernel 5 {n5}")
    flash_row["launches"] += n8
    kernels[[k["name"] for k in kernels].index("flash_attention_bwd")][
        "launches"] += n8b
    router_row["launches"] += n5

    # LM serving on the mesh gets the card to itself
    del mt
    gc.collect()
    torch.cuda.empty_cache()
    log("[27] LM serving on a one-rank NCCL mesh (data 1 x model 1): "
        "build_step prefill -> greedy decode, meshed vs no mesh, for "
        "Llama-3.2-1B, Qwen3-30B-A3B and DeepSeek-V2; kernel 8's split "
        "decode merged across sequence slices")
    t_phase = time.perf_counter()
    ms = phase_mesh_serve(dev)
    ms["wall_s"] = time.perf_counter() - t_phase
    log(f"    {ms['mesh']} on {card}")
    for name, o in [("llama3_2_1b", ms["llama"])] + list(ms["moe"].items()):
        for key in ("plain", "mesh"):
            r = o[key]
            log(f"    {name} {key}: (prefill s, decode ms/step) in its two "
                f"turns {r['turns']}, peak {r['peak_gib']:.2f} GiB (both "
                f"models resident; the run's own {r['grown_gib']:.2f}), "
                f"launches {r['launches']} on {card}")
        log(f"    {name}: greedy tokens equal {o['tokens_equal']}; expert "
            f"ids equal on {o['pairs']} (token, layer) rows: "
            f"{o['ids_equal']}; max |logit diff| mesh vs no mesh "
            f"{o['max_logit_diff']!r}, bitwise {o['bitwise']}"
            + (f"; reduced: {o['reduced']}" if "reduced" in o else ""))
    mg = ms["merge"]
    log(f"    kernel 8 split decode merged over {MERGE_SPLITS} sequence "
        f"slices at kv_len {MERGE_LENS}, {mg['layers']} layers: f32 max "
        f"|diff| {mg['f32']!r} (limit 1e-5); bf16 max |diff| "
        f"{mg['bf16']!r}, {mg['bf16_ulps']!r} bf16 ulps at the partials' "
        f"scale (limit 1); {mg['empty_slices']} empty (row, slice) pairs; "
        f"NaN {mg['nan']}")
    log(f"    phase wall {ms['wall_s']:.1f}s")
    runs = [ms["llama"]["mesh"]] + [o["mesh"] for o in ms["moe"].values()]
    n8 = sum(r["launches"]["flash prefill"] + r["launches"]["flash decode"]
             for r in runs)
    n8_split = sum(r["launches"]["decode routes"]["split"] for r in runs)
    n5 = sum(r["launches"]["select"] for r in runs)
    check(n8_split > 0 and n5 > 0,
          f"phase 27 launches: kernel 8 {n8} ({n8_split} split), 5 {n5}")
    log(f"    launches on the meshed serving paths: kernel 8 {n8} "
        f"({n8_split} on \"split\"), kernel 5 {n5}")
    flash_row["launches"] += n8
    router_row["launches"] += n5

    # the GNN family gets the card to itself
    del ms
    gc.collect()
    torch.cuda.empty_cache()
    log("[28] the GNN family: EGNN at full width (4 layers, hidden 64, "
        "d_out 47; f32, TF32 off) on its four cells through build_step, "
        "no kernel on the path")
    t_phase = time.perf_counter()
    gn = phase_gnn(dev)
    gn["wall_s"] = time.perf_counter() - t_phase
    log_gnn(gn, card)
    log(f"    phase wall {gn['wall_s']:.1f}s")

    log("[29] the dry run's estimates (launch/dryrun.py: the step counted "
        "on meta tensors) against the card's readings of phases 23 and 28")
    t_phase = time.perf_counter()
    es = phase_estimates(lt, gn)
    log(f"    {card}")
    log_estimates(es, card)
    log(f"    phase wall {time.perf_counter() - t_phase:.1f}s")

    log("[30] the port's examples in this process: quickstart, serving "
        "(exact kernel / sequential, approx), the paper's sweep (sequential,"
        " ring), the ~100M LM with a fault; then python -m "
        "repro_torch.analysis")
    t_phase = time.perf_counter()
    ex = phase_examples(dev)
    log(f"    {card}")
    log_examples(ex, card)
    for k in kernels:
        k["launches"] += ex["launches"].get(k["name"], 0)
    log(f"    phase wall {time.perf_counter() - t_phase:.1f}s")

    # DeepSeek-V2's train step gets the card to itself
    del ex
    gc.collect()
    torch.cuda.empty_cache()
    b, s = MLA_TRAIN_SHAPE
    log(f"[31] DeepSeek-V2 training at full width: {MLA_TRAIN_DEPTH} layer "
        f"(the first, dense), train_4k cut to {b} x {s} "
        f"({MLA_TRAIN_MICROBATCH} µbatches, remat, AdamW), "
        f"{MLA_TRAIN_STEPS} build_step train steps; kernels 8 and 8b at "
        f"MLA's 192 / 128 heads on \"mma\"")
    t_phase = time.perf_counter()
    dt = phase_mla_train(dev)
    dt["wall_s"] = time.perf_counter() - t_phase
    log_mla_train(dt, card)
    mla_row["launches"] += dt["launches"]["forward"]
    mla_bwd["launches"] += dt["launches"]["backward"]

    check(all(math.isfinite(k["ms"]) for k in kernels), "finite timings")
    print(card)
    print(json.dumps({"kernels": [{key: k[key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
