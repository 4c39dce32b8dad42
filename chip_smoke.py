#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sparse_coding_tpu_torch``) on one
NVIDIA GPU. Imports nothing of JAX and nothing of the JAX package.

Phases — any failure raises, and the script exits non-zero with no result:

1. card: name and power limit (nvidia-smi), then all eight CUDA kernels
   are built from ``sparse_coding_tpu_torch/ops/csrc`` (one nvcc per
   source, all started together), with their ptxas register and spill
   lines — every instantiation of the fp32 GEMM template and of the
   bf16 TMA + wgmma one among them, each in exactly the six chunked
   kernels (big_sae_fwd, big_sae_bwd, sae_tied_fwd, sae_tied_bwd,
   sae_untied_fwd and sae_untied_bwd), where any spill fails the run;
   those six libraries' SASS must hold HGMMA instructions;
2. kernels: each ensemble kernel (sae_tied_fwd, sae_tied_bwd,
   sae_tied_adam_vjp, sae_untied_fwd, sae_untied_bwd, sae_untied_adam_vjp)
   and each contract
   (K1 fused_tied_sae_grads, K2 fused_tied_sae_train_step, K3
   tiled_tied_sae_grads, K4 fused_tied_adam_vjp_update, K5
   fused_untied_sae_grads, K6 fused_adam_vjp_update, K7
   tiled_untied_sae_grads, and K1/K3 with the masked family's coef_mask)
   is held against its plain PyTorch version on the same inputs on the
   card, at the main path's shapes and at small odd shapes up to the
   kernels' widest d (40, 600, 768 and the LM widths 1000, 1024, 2048,
   3072 and 4096, the widest); each kernel and its plain version are timed at
   the main path's shapes, the tied Adam epilogue's share of its byte
   bound logged beside its ms;
3. tied main path: a synthetic activation store (d=512) is written with
   the port's ChunkWriter, then ``basic_l1_sweep`` trains 32 tied SAEs (an
   L1 grid, ratio 4, batch 2048) for one epoch (208 steps, metrics at
   steps 100 and 200) on the default kernel path ``train_step_tiled``,
   with every launch count zeroed just before and read just after; the
   logged losses must be finite, eval.json must order the L1 grid, and
   the artifacts must load; then the same epoch from the same init in the
   same batch order on the autodiff path (plain PyTorch, no kernel): each
   member's logged single-batch mse must match the main path's;
4. untied main path: the same on ``basic_l1_sweep(tied=False)`` — 32
   untied SAEs on ``train_step_tiled``, whose kernels must each launch
   once per step while the tied ones do not launch;
5. untied reference: that epoch replayed on autodiff, as in phase 3;
6. other paths: a few steps each of the four tied and the four untied
   kernel paths through ``Ensemble`` (counts zeroed before each), and of
   the masked-tied family's two paths at the dictionary-ratio shape (7
   members of ratios 0.5–32 padded to 16,384 features), each held against
   the autodiff path from the same init on the same batches;
7. big-SAE main path: ``train_big_sae`` at ``BigSAEArgs``' defaults (d=1024,
   16,384 features, batch 65,536; depth cut to 2 epochs of a 4-chunk
   synthetic store = 16 steps, resurrection every 8) on its kernels
   (``big_sae_fwd``/``big_sae_bwd``, once per step; counts zeroed just
   before), its activations/s over steps 2–16, the same run replayed on
   autodiff, 3 steps of the kernel and autodiff steps side by side,
   resurrection of 20 marked features on the card vs on the CPU, and the
   export's FVU on held-out rows;
8. the full sweep (``train/sweep.py``) through its CLI, ``main``:
   ``tied_vs_not`` at the main paths' width (16 tied and 16 untied
   members over ``DEFAULT_L1_RANGE``, batch 2048) over a 4-chunk store
   (64 steps; 6 until phase 19 took the run past its time), a checkpoint
   set every chunk; (a) every kernel of both
   families launches once per step (counts zeroed just before) and the
   logged losses are finite; (b) a child SIGKILLed by
   ``SPARSE_CODING_CRASH_PLAN`` at ``sweep.chunk`` (hit 3), then at
   ``ckpt.swap`` (hit 3), resumed with ``--resume true``, ends with
   learned dicts and a checkpoint set bitwise equal to (a)'s; (c) a child
   SIGTERMed mid-run exits 0 (``SweepPreempted``) and resumes bitwise;
   (d) the guardian drill ``sweep.anomaly`` member=3 freezes and tags
   tied member 3 and leaves every other member bitwise (a)'s; (e) a NaN
   batch rolls back and replays bitwise equal to a run over the store
   with that chunk quarantined; (f) ``dict_ratio`` 2 chunks at the
   masked shape on its kernels; (g) the sweep on autodiff: each member's
   final logged loss within 1e-2 of (a)'s; (h) the same sweep with
   ``--train_dtype bfloat16`` (half-width batches to the card) ends
   bitwise equal to (a) — the store is bfloat16 on disk. (b)'s and (c)'s
   children run as three chains at once beside (d), (e), (f) and (h) in
   this process, (g) after them alone.
   Measured: the sweep's
   activations/s, the checkpoint seconds per chunk, the resume time and
   the probe's ``train.mfu``;
9. the full sweep's host I/O: phase 8's store re-sharded into 2 + 2
   chunks (``data/shard_store.py``) and ``--checkpoint_backend orbax``
   (the deferred swap, ``utils/orbax_ckpt.py``) at phase 8's shape; (a)
   each kernel launches once per step and the learned dicts, eval.json
   and final ``ckpt/`` files are bitwise phase 8 (a)'s msgpack run over
   the flat store; (b) a child SIGKILLed at ``sweep.chunk`` hit 3, while
   the chunk-3 set is being written, leaves chunk 2's set in ``ckpt/``
   and resumes from it bitwise; (c) a child SIGTERMed mid-run exits 0
   with its issued set swapped in and resumes bitwise; (d) a
   ``SPARSE_CODING_FAULT_PLAN`` error at ``ckpt.save`` on the second set
   fails the child with the typed error and leaves the first set in
   ``ckpt/`` ((b), (c) and (d) as three chains of children at once); (e)
   measured beside phase 8's run: acts/s, chunk wall, the
   set's time in the sweep (issue), the wait before each swap, the
   workers' writes, the read path that served the chunks (native or
   np.load) and the host→device stage; (f) both backends over 2 chunks of
   131,072 rows, bitwise equal to each other, their chunk walls measured;
10. bf16 compute (``fused_compute_dtype="bfloat16"``,
   ``fused_moments_dtype="bfloat16"``): (a) each bf16 form of the four
   chunked ensemble kernels against its plain bf16 version at small odd
   shapes (d=40, 600, 768, 1032, 2048, 4096), the main shape and ratio
   16, with fp32 and
   bf16 batches and the coef_mask, within RTOL_BF16, its ReLU mask flips
   capped (one per million codes; the untied dWn with each flipped code's
   terms moved to the kernel's side, after its bf16 codes are found equal
   to its fp32 codes rounded and those within their sums' rounding bound
   of the plain ones), and two calls bit-identical; (b) the
   two Adam epilogues with bf16 moments against their plain versions;
   (c) bench.py's five bf16 variants through ``Ensemble``, tied and
   untied, one epoch (208 steps) each: each bf16 form launches once a
   step and no fp32 forward or backward does, the losses are finite and
   each member's mse stays within RTOL_BF16_MSE of the fp32 kernel
   path's from the same init on the same batches; (d) each bf16 form
   and its launches timed beside its plain version (the tied Adam
   epilogue with bf16 moments with its share of its bound; the products with
   their TFLOP/s, the backwards' beside one cuBLAS bf16 ``torch.bmm`` of
   each product's shape, a yardstick the port never calls), the step's
   ms and acts/s beside the fp32 path's; (e) the bf16 forms join the kernels
   line; (f) the paths bench.py's variants leave out (the tiled ones,
   bf16 moments on ``train_step_tiled``, the masked family's two), three
   steps each with bf16 batches: each bf16 form once a step, finite
   losses;
11. bf16 compute in the big SAE (``make_big_sae_step(
   fused_compute_dtype="bfloat16")``): (a) ``big_sae_fwd_bf16`` and
   ``big_sae_bwd_bf16`` against their plain bf16 versions at d=40, 128,
   640, 1024, a batch of several chunks under a lowered cap and under the
   real one, and the main shape (phase 7's first batch), the untied and
   the tied residual: the kernel's ReLU mask flips (counted against the
   plain version's masks) at most one per million codes, dE within
   RTOL_BF16 on the features without a flip, x̂, dWn, dt, dctr and
   c_totals on all, l1 within RTOL_EXACT, l0 within the flips; two calls
   bit-identical, peak memory beside the plain versions'; (b)
   phase 7's 16 steps (same init, store, batch order, resurrection every
   8) through ``make_big_sae_step(use_fused=True)`` in fp32 and in bf16:
   each bf16 form once a step and no fp32 big-SAE kernel, finite losses,
   each within RTOL_BIG_BF16_LOSS of the fp32 run's; (c) the JAX
   package's ``bench_big_sae`` variants (autodiff, fused, fused_bf16) at
   d=1024, n=16,384, batch 16,384 (15 iterations) and at the capacity
   shape n=131,072 (5), activations/s from synced windows — an
   out-of-memory error on autodiff is that variant's result; (d) each
   bf16 form and each of its launches timed beside its plain version (K8
   bf16's per launch: round, codes, decode), the bf16 step's ms and
   acts/s beside the fp32 step's; (e) the two forms
   join the kernels line;
12. the model zoo (the rest of slice 1 and the sweep's group
   experiments): (a) the JAX package's recovery gate
   (``tests/test_synthetic_recovery.py``: d=64, 96 true features, three
   192-atom tied dicts, batch 512, 2000 steps, lr 3e-3) through
   ``Ensemble``'s default path — the tied kernels, once a step — with
   best representedness > 0.9 and lowest FVU < 0.15; then
   ``basic_l1_sweep`` at the main shape over a ``SparseMixDataset`` store
   (3 chunks of 32,768 rows at d=512) on ``train_step_tiled``, its dicts'
   ``mmcs_to_fixed``, representedness and ``hungarian_mcs`` against the
   ground truth, and ``n_ever_active`` and ``calc_moments_streaming``
   over the store on the card against the same scans on the CPU (counts
   equal, moments within RTOL_MOMENTS); (b) the seven group experiments
   (``topk``, ``residual_denoising``, ``centered_l1_range``,
   ``reverse_l1_range``, ``positive_l1_range``, ``semilinear_l1_range``,
   ``rica``) through the sweep's CLI over 2 chunks of phase 8's store:
   their ``learned_dicts.pkl`` loads, every member's logged loss is
   finite, acts/s over the second chunk; and each experiment's entries
   at the full width (two grid points) three steps on the card against
   the CPU from one init (losses within RTOL_PATH_LOSS, each bucket's
   whole weights within REL_FRO_PATH — a LISTA bucket's within
   REL_FRO_LISTA, its first step's shrinkage flips between the two sides
   counted and capped, its features that never flipped read, not held:
   ``lista_side_check``); (c) ``topk`` (six
   buckets) SIGKILLed mid-swap of its second checkpoint set and resumed,
   bitwise (b)'s run; (d)
   ``export_reference_learned_dicts`` of (a)'s and (b)'s exportable dicts
   and ``load_reference_learned_dicts`` back on the card: equal fields,
   encode within RTOL_INTEROP (a TopK dict's selection may flip where two
   scores lie within a rounding: at most one code per million), the other
   classes refused;
13. harvest and train at an LM's width: (a) ``harvest_activations`` on
   the card — the ``EleutherAI/pythia-70m-deduped`` preset at full width
   (d_model 512, 6 layers, d_mlp 2048, vocab 50,304) with seeded random
   weights, seeded random token ids (context 256, model batch 4), taps
   ``mlp.1`` and ``mlp.2`` into a bf16 store of 2 chunks of 32,768 rows
   a tap (``chunk_size_gb`` cut from 2.0 to 0.125); tokens/s and the
   harvest's wall; (b) the first 8 token rows through the forward on the
   card and on the CPU, same weights: every tap location and the logits
   within RTOL_LM of max|ref|, and the first rows of the card's chunk 0
   within one bf16 ulp of the CPU's taps rounded to bf16 (plus RTOL_LM);
   (c) ``basic_l1_sweep`` over the ``mlp.2`` store, 16 tied members over
   an L1 grid, ratio 4 (n=8192), batch 2048, one epoch (32 steps), on
   ``train_step_tiled``: each tied kernel once a step (counts zeroed just
   before), finite losses, eval.json ordering the grid, artifacts that
   load, acts/s; (d) the same untied on the untied kernels; (e) for both
   families 3 steps on the kernels and 3 on autodiff from one init on the
   same batches at phase 6's bounds, then each ensemble kernel at that
   shape against its plain version and timed, the tied Adam epilogue
   (fp32 and bf16 moments) with its share of its bound; (f)
   ``scrub_store`` over (a)'s store
   reads clean, names a chunk with one flipped byte, and with repair
   quarantines it;
14. evaluate on the card, on phase 13's LM, stores and tied ``mlp.2``
   dicts (16 members, n=8192): (a) ``run_toy_replication`` at
   ``ToyArgs``' defaults (d=128, 256 true features, batch 256, 390
   steps) and at the JAX gate's config (d=48, 64 features, ratio 1.5,
   batch 512, 703 steps), each tied kernel once a step (counts zeroed
   before each), finite metrics, the gate's best representedness above
   0.85; (b) ``basic_l1_sweep`` over ``mlp.1``'s sound chunk (the scrub
   quarantined chunk 1), 4 tied members at ratio 4, batch 2048, each
   tied kernel once a step; (c) ``calculate_perplexity`` at ``mlp.2``
   over 64 + 8 token rows of 256 (model batch 16, a tail of 8) for the
   model, ``Identity`` (equal to the model's to 1e-6) and the 16 dicts,
   beside their L0 and FVU, tokens/s; card vs CPU over 8 rows and two
   dicts; (d) ``build_ablation_graph_non_positional`` from a (b) dict to
   an ``mlp.2`` dict, 8 sources, 64 targets, 8 rows of 64 tokens, card vs
   CPU; (e) ``run_ioi_feature_ident`` at ``mlp.2`` with a crc32 stub
   tokenizer: 1,024 features ranked on the card (timed), card vs CPU
   over 32 (rankings, effects, the cumulative ablation curve); (f)
   ``probe_activations`` of prompts with a planted label token,
   ``feature_erasure_curve`` with the LM's KL and ``leace_baseline``,
   card vs CPU (sklearn's probe, or with no sklearn on the host
   ``closed_form_probe``; ``run_erasure`` end to end when sklearn and
   matplotlib are there); (g) ``activity_sweep`` and ``kurtosis_sweep``
   over the ``mlp.2`` store (timed) and card vs CPU on 8,192 rows and 2
   dicts; FISTA codes and a ``ConcatEnsembleDict``, card vs CPU;
   ``resurrect_ensemble_features`` on (b)'s ensemble; PCA card vs CPU
   and the baseline exports (``run_layer_baselines`` whole with
   sklearn); its wall time;
15. interpret features on the card, on phase 13's LM, stores and tied
   ``mlp.2`` dicts (member 0, the live one) and phase 14 (b)'s ``mlp.1``
   dict; cut to: 5,000 token rows of 128 tokens, 64 fragments card vs CPU,
   4 investigated features, a 2-chunk sweep of 3 members with 256
   fragments and 4 features a member, 4,096 rows and 2 dicts for the
   catalog's card vs CPU, 8,192 rows for the plotting data: (a)
   ``interp.run.run`` at ``InterpArgs``' defaults (5,000 fragments of 64
   tokens, batch 20, 10 features, top and random 10, offline) at
   ``mlp.2``: tokens/s of the fragment pass, features explained per
   second, and a second run rewrites no ``scores.json``; (b) 64 fragments
   on the card and on the CPU with (a)'s features: the maxes within
   RTOL_EVAL, the top fragments equal but at near-ties, the explanations
   equal where they agree, the scores within SCORE_TOL; (c)
   ``scan_batches`` 8 against 1 over (a)'s first 180 fragments (a window
   and a tail batch): bit-identical maxes (the field changes nothing in
   the port);
   (d) ``run_interp_graph`` at ``InterpGraphArgs``' defaults (64
   fragments of 32 tokens) from the ``mlp.1`` dict to the ``mlp.2`` dict,
   positional and not, 8 sources and 64 targets, card vs CPU within phase
   14 (d)'s bound, and ``investigate_features`` on 4 live features; (e)
   the sweep CLI, ``zero_l1_baseline`` tied over 2 chunks of the ``mlp.2``
   store with a snapshot a chunk, each tied kernel once a step (counts
   zeroed before), ``interpret_across_chunks`` (the same features pinned
   in both snapshots) and ``interpret_across_big_sweep``,
   ``plot_n_active_over_time``'s series, ``read_transform_scores``, and
   ``python -m sparse_coding_tpu_torch.interp.run`` with ``interpret``
   and ``chunks`` on tiny-gptneox on the card and ``read_results`` of
   (a)'s folder, three children at once (after every timed step, beside
   the untimed checks only: (b), (c) and the card-vs-CPU sides of (d),
   (f) and (g), so that no timed step shares the card or the host with
   them); (f)
   ``build_catalog`` over the 16 tied ``mlp.2`` dicts and the whole store
   (2 × 32,768 rows), twice, byte-identical, ``CatalogIndex.load(
   verify=True)`` and one live feature's stats; card vs CPU on 4,096 rows
   and 2 dicts (dead flags equal, counts but one flip per million codes,
   mag within RTOL_CATALOG_MAG, mmcs within CATALOG_MMCS_TOL, matches but
   at near-ties); ``neighbor_topk`` (k=8, 512 rows) and ``union_vote``
   over the 16-member stack, card vs CPU; (g) ``generate_scores`` and
   ``n_active_features`` over phase 13's two artifacts on 8,192 ``mlp.2``
   rows (card vs CPU over their first members within RTOL_EVAL, counts
   equal), ``sweep_grid`` on the scores; no figure is drawn;
16. the mesh (``parallel/``): (a) the chunked backwards' data-sharded
   form (``total_batch`` ≠ b: sae_tied_bwd, masked too, and
   sae_untied_bwd in fp32 and bf16 at the canonical shape with total_batch
   4096; big_sae_bwd fp32 and bf16 on 32,768 rows of BigSAEArgs' 65,536)
   against their plain versions with phase 2's and phases 10-11's bounds
   and ReLU flips counted; (b) a 1 × 1 mesh over NCCL (a world of one):
   ``basic_l1_sweep`` at the canonical shape (2 chunks, 32 steps) on the
   mesh, the tied kernels once a step, its dicts bitwise equal to the
   same steps without a mesh; (c) a two-rank gloo world whose ranks share
   the card (this script's ``--mesh-worker``), meshes 2 × 1 and 1 × 2:
   the tied and untied ensembles at the canonical shape on
   train_step_tiled and the big SAE at BigSAEArgs' shape in fp32 and
   bf16, 3 steps each, every kernel of each path launching on each rank,
   held against one device at phase 6's bounds (losses, weights) and
   phase 7's side-by-side bounds (metrics; params within
   REL_FRO_BIG_REPLAY). Two ranks on one card check correctness; their
   times are no multi-GPU figure;
17. serving (``serve/``, ``xcache/``, ``catalog/serve.py``) on phase
   13's 16 tied ``mlp.2`` dicts (d=2048, n=8192), its harvested rows and
   phase 15 (f)'s catalog: (a) a registry of one dict (``load_native``)
   and the 16-dict stack, a gateway of 2 replicas and a spare over one
   program table, every (model, op, bucket) program captured as a CUDA
   graph at warmup (ops encode, decode, topk, predict, neighbors, vote;
   the default ladder 8/64/512), the graph pool's and the pinned staging
   bytes; (b) every program at a partial bucket bitwise the eager op at
   the same padded bucket, and at bucket 8 against the port on the CPU
   within RTOL_EVAL (top-k indices equal but at near-ties, vote flips
   capped), ``neighbor_topk`` equal to its stable-sort plain version and
   both timed; (c) 48 requests an op of 1-512 rows (log-uniform, seeded)
   through the gateway: rows/s per op, p50/p99 per bucket, 0 recompiles;
   (d) the ``serve.dispatch`` fault plan trips one replica (failover
   answers every request; the spare activates at 0 captures) and a swap
   to the ladder derived from (c)'s traffic captures only its new rungs;
   (e) ``score_offline`` over a 32,768-row chunk, and ``CatalogService``
   stats/neighbors/search/union card vs CPU; (f) a restarted process
   (this script's ``--serve-restart``), started after (a) beside the
   untimed checks ((b) and (e)'s catalog service):
   the kernel libraries load with 0 nvcc runs, ``warmup_from_manifest``
   captures exactly (a)'s manifest, 0 captures after admission, its
   first request's latency;
18. the supervised pipeline (``pipeline/``, ``fsck/``, ``obs/``): (a)
   ``build_pipeline`` + ``Supervisor`` run harvest → sweep → eval →
   catalog as step children on the card — a synthetic store at d=512 (4
   chunks of 32,768 rows, fp16), ``dense_l1_range`` (16 tied members,
   ratio 4, batch 2048, a checkpoint set a chunk, an 8-step trace
   window), eval on 2,048 rows, the catalog — each step's wall from the
   run report, each tied kernel launched once a step and no untied one
   (the report's ``kernel.launches`` counters, its path
   ``train_step_tiled``), 0 nvcc runs in the children, eval.json's FVU and
   L0 recomputed here within RTOL_PIPE_EVAL; (b) the children SIGKILLed
   through the crash plan at ``sweep.chunk`` (hit 2) and at ``eval.write``
   by two supervisors, then a fresh one — preflight fsck on — resumes
   ((a) runs alone first): chunks, the last checkpoint set, dicts,
   eval.json and the catalog bitwise (a)'s, the kills and the lease
   takeovers journaled; (c) a fake step that never beats
   (``heartbeat_stale_s`` 2 s, beside (b)'s two killed runs): the card
   probe's report and its verdict (halt: the card answers) journaled;
   (d) fsck of (a)'s
   tree clean, one flipped chunk byte fatal and the preflight halting
   with ``PreflightAuditError``, one perf-ledger row; (e) the sweep's
   trace names the kernels in its device events, captured once, skipped
   never. No attempt may be degraded, and every step span must say cuda
   and have held memory on the card;
19. Group-SAE and the fleet (``groups/``, ``pipeline/fleet.py``,
   ``fleet_queue.py``, ``placement.py``, ``plane.py``): (a)
   ``build_group_pipeline`` under a ``Supervisor`` on the card — four
   multi-tap writers (d=512, layers 0-3, 2 chunks of 32,768 rows each,
   the per-layer mix at phase_step 0.35), manifest, scrub, group — must
   reach the G=2 assignment [[0, 1], [2, 3]], with ``similarity.npy``
   bitwise a host pass over the same store, a rebuild rewriting every
   group file byte for byte and a resumed supervisor skipping every step;
   (b) ``enqueue_group_tenants`` (one ``kind="group"`` tenant per pool:
   ``dense_l1_range``, 16 tied members, ratio 4, batch 2048, a checkpoint
   set a chunk, 64 steps, eval on 2,048 rows) with group-000 poisoned
   (``sweep.anomaly`` NaN, rollback budget 1) through
   ``FleetScheduler.run()``, two tenants side by side: group-000 halts
   inside its own run, group-001 finishes bitwise a standalone in-process
   ``run_sweep`` + ``run_eval`` of its config (the sweep trains as the
   fleet starts, while every child still imports torch: its acts/s are
   the card's alone, and the overlap with any step child is measured),
   its sweep child launches
   each tied kernel once a step (its run report), no tenant runs nvcc or
   captures a graph, every step span on cuda holding card memory; the
   fleet report shows the halt; fsck of the fleet and the store finds
   nothing fatal; (c) an ``ElasticPlane`` over the fleet and a
   1-active/1-spare gateway on phase 17's registry, a scavenger copy of
   group-001: two ticks of held load record the scale-up before the
   reclaim, the scavenger checkpoints out through SIGTERM (not killed),
   the spare activates with 0 captures, the scale-down drains then
   releases the replica a tick later, the scavenger resumes to group-001's
   bits, and a fresh arbiter's ``reconcile()`` drives both consumers to
   recorded splits;
20. long-context harvest and the giant SAE at an LM's MLP width: (a)
   ``big_sae_fwd``/``big_sae_bwd`` and their bf16 forms against their
   plain versions at BigSAEArgs' n (16,384) and d = 1,032, 1,500 (fp32
   only), 2,048, 3,072 and 4,096 (the kernels' widest, BIG_MAX_D) on
   8,192 rows, and on 36,864 rows at d = 2,048 (several workspace chunks
   each, the fp32 launch counts checked), with phase 2's and phase 11's
   bounds; (b) ``harvest_activations(mesh=...)`` over 16 contexts of
   8,192 tokens (4x the preset's n_ctx) of phase 13's model (Pythia-70M at
   full width, its own seeded random weights), taps ``mlp.2`` and
   ``residual.2``, bf16 chunks of 65,536 rows: on the card alone, on a
   1 × 1 NCCL mesh and on a 1 × 2 gloo world of two ranks sharing the card
   (this script's ``--ring-worker``, beside the untimed checks: (c)'s side
   by side and (a); ring attention's key/value blocks through pinned host
   memory); the sequence-parallel forward of the
   first context (every layer, the logits) against the single-device
   forward within RTOL_LM of max|ref| on every rank, both mesh stores'
   chunks within one bf16 ulp (and RTOL_LC of max|ref|) of the
   single-device store's, tokens/s of each harvest; (c) K8 and K9 (fp32
   and bf16) timed at d = 2,048, BigSAEArgs' batch and n, on the
   harvested rows beside their bounds; ``train_big_sae`` over the 1 × 1
   NCCL mesh's ``mlp.2`` store at d = 2,048 with BigSAEArgs' n and batch
   (``use_fused`` "auto"), 4 steps in fp32 and 4 with its step built for
   bf16 compute: each kernel once a step, each bf16 loss within
   RTOL_BIG_BF16_LOSS of the fp32 one, acts/s; then 3 kernel steps beside
   3 autodiff steps from one init (metrics within RTOL_BIG_STEP, params
   within REL_FRO_BIG_REPLAY);
21. summary: one ``{"kernels": [...]}`` line (the tied kernels also with
   phase 15 (e)'s launches, every kernel with phase 16's, phase 18's,
   phase 19's and phase 20's, the big-SAE kernels with their time and
   bound at d = 2,048),
   the card's name and power limit, and the last line
   ``{"ok": true, "device": {...}}``.

Phase 2 also holds the four chunked ensemble kernels against their plain
versions at the ratio-16 width (n = 8,192, which their 1 GiB workspaces
take in 2 chunks of 16 members for the forwards and 4 chunks of 8 for
the backwards; the tied pair with and without a coef_mask), and at the
main shape (the forwards and the tied backward at ratio 16 too, the tied
forward with and without a coef_mask) checks that two calls give the
same bits, records one call's peak memory beside the plain version's and
times each of their launches. At every shape the tied backward's dW and
db (sae_tied_bwd's, and K1's and K3's, which run it) are held with its
ReLU mask flips counted against the plain version's masks
(``tied_bwd_flips``): at most one per million codes, each within 1e-2 of
the sums' rounding bound of 0, and its dW and db held against the plain
version within rtol 1e-3 on every feature with no flip and, with each
flip's terms moved to the kernel's side, on every feature. It holds
``big_sae_fwd``/``big_sae_bwd`` against their plain versions at the
big-SAE shape, at small odd shapes up to d = 1,024 (phase 20 (a) takes
them on to their widest, 4,096) and at a batch that both take in several
chunks (the last one short: 3 for K8, 5
for K9); at the big-SAE shape it checks K8's and K9's repeat and memory
the same way and times each of their launches on one chunk.

The six chunked kernels count their launches in two families:
``big_sae_fwd``, ``big_sae_bwd``, ``sae_tied_fwd``, ``sae_tied_bwd``,
``sae_untied_fwd`` and ``sae_untied_bwd`` count calls of their
contracts; their own launches count under ``_build.TIED_BWD_PARTS`` and
``_build.UNTIED_BWD_PARTS`` (norms and loss once per call, the products
and the sums once per chunk), ``_build.TIED_FWD_PARTS`` and
``_build.UNTIED_FWD_PARTS`` (norms once per call, the codes and decode
products once per chunk), ``_build.BIG_FWD_PARTS`` (once per batch
chunk) and ``_build.BWD_PARTS`` (once per batch chunk; dctr once per
call). The masked family's shape (7 members of 16,384 features) takes
the tied forward in one member chunk and the tied backward in 2 (4 + 3).

Run from the repository root: ``python3 chip_smoke.py`` (one card;
``--report PATH`` also writes every measurement as JSON).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# A host whose Python writes no bytecode (PYTHONDONTWRITEBYTECODE), with
# none shipped beside torch, compiles torch's sources anew in every
# process: `import torch` took 8.6-9.3 s a process on the H100 host. The
# script and every process it starts (the sweep CLI's children, the mesh
# ranks, the pipeline's step children) share one bytecode cache beside it.
if sys.flags.dont_write_bytecode and "PYTHONPYCACHEPREFIX" not in os.environ:
    BYTECODE_DIR = str(Path(__file__).resolve().parent / ".chip_smoke_bytecode")
    os.environ["PYTHONPYCACHEPREFIX"] = BYTECODE_DIR
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix, sys.dont_write_bytecode = BYTECODE_DIR, False

import numpy as np  # noqa: E402 — after the bytecode cache is set
import torch  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth. The kernels run true fp32 (no TF32).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# main paths: Pythia-70M residual width, ratio 4, a 32-member L1 grid
D, RATIO, N_MEMBERS, BATCH = 512, 4, 32, 2048
N_FEATS = D * RATIO
ROWS_PER_CHUNK = 16 * BATCH
# one epoch of 13 chunks = 208 steps: basic_l1_sweep logs every 100 steps,
# so the main paths log at steps 100 and 200
N_CHUNKS = 13
SEED, LR = 0, 1e-3
DEV = "cuda"
# the dictionary-ratio experiment (JAX train/experiments.py
# dict_ratio_experiment): one masked-tied bucket of mixed dictionary sizes
MASKED_RATIOS = (0.5, 1, 2, 4, 8, 16, 32)
MASKED_L1 = 8.577e-4

# tolerances of kernel vs plain version, both fp32 on the card. Float
# outputs: |Δ|max <= RTOL·max|ref|. The two sides sum in different orders
# (blocked SIMT loops vs cuBLAS), ~1e-6 relative; a pre-activation within
# rounding of 0 can flip its ReLU mask on one side, which moves that
# feature's weight-grad row by |dpre·x| and its activity count by 1 — so
# grad-like outputs carry a looser bound and activity a count bound.
RTOL_EXACT = 1e-5     # r, losses, the Adam epilogue on identical inputs
RTOL_GRAD = 1e-3      # dW/dE/dWn, db and everything Adam computes from them
ACT_COUNT_TOL = 8     # activity: mask flips per (member, feature)
RTOL_PATH_LOSS = 1e-4  # per-step losses of a kernel path vs autodiff
# A kernel path's weights vs autodiff's after a few steps from a fresh
# init, as ‖ΔW‖/‖W‖ (the encoder, and the untied decoder): Adam's first
# steps move each element by about ±lr·sign(g), so an element whose
# gradient lies within rounding of 0 can step the other way (2·lr) on one
# side — a handful among tens of millions of elements.
REL_FRO_PATH = 1e-4
# A main path's logged single-batch mse vs the autodiff reference's at
# the same step, |Δ|/mse per member: 100–200 Adam steps grow the paths'
# rounding differences (phase 6's 1e-5-level gaps after 3 steps), but a
# kernel fault moves the mse far more than this.
RTOL_REFERENCE_MSE = 1e-2

KERNEL_META = {
    "sae_tied_fwd": {
        "source": "sparse_coding_tpu_torch/ops/csrc/sae_tied_fwd.cu",
        "replaces": "sparse_coding_tpu/ops/fused_sae_tiled.py:344",
        "contracts": ["K1", "K2", "K3"]},
    "sae_tied_bwd": {
        "source": "sparse_coding_tpu_torch/ops/csrc/sae_tied_bwd.cu",
        "replaces": "sparse_coding_tpu/ops/fused_sae_tiled.py:387",
        "contracts": ["K1", "K2", "K3"]},
    "sae_tied_adam_vjp": {
        "source": "sparse_coding_tpu_torch/ops/csrc/sae_tied_adam_vjp.cu",
        "replaces": "sparse_coding_tpu/ops/fused_sae.py:1053",
        "contracts": ["K2", "K4"]},
    "sae_untied_fwd": {
        "source": "sparse_coding_tpu_torch/ops/csrc/sae_untied_fwd.cu",
        "replaces": "sparse_coding_tpu/ops/fused_sae_tiled.py:501",
        "contracts": ["K5", "K7"]},
    "sae_untied_bwd": {
        "source": "sparse_coding_tpu_torch/ops/csrc/sae_untied_bwd.cu",
        "replaces": "sparse_coding_tpu/ops/fused_sae_tiled.py:504",
        "contracts": ["K5", "K7"]},
    "sae_untied_adam_vjp": {
        "source": "sparse_coding_tpu_torch/ops/csrc/sae_untied_adam_vjp.cu",
        "replaces": "sparse_coding_tpu/ops/fused_sae.py:930",
        "contracts": ["K6"]},
    "big_sae_fwd": {
        "source": "sparse_coding_tpu_torch/ops/csrc/big_sae_fwd.cu",
        "replaces": "sparse_coding_tpu/ops/fused_big_sae.py:214",
        "contracts": ["K8"]},
    "big_sae_bwd": {
        "source": "sparse_coding_tpu_torch/ops/csrc/big_sae_bwd.cu",
        "replaces": "sparse_coding_tpu/ops/fused_big_sae.py:253",
        "contracts": ["K9"]},
}
TIED_KERNELS = ("sae_tied_fwd", "sae_tied_bwd", "sae_tied_adam_vjp")
UNTIED_KERNELS = ("sae_untied_fwd", "sae_untied_bwd", "sae_untied_adam_vjp")
BIG_KERNELS = ("big_sae_fwd", "big_sae_bwd")

# the giant single SAE at config.BigSAEArgs' defaults; depth is the only
# cut: 2 epochs of a 4-chunk store (131,072 rows a chunk) = 16 steps, with
# resurrection every 8 instead of 500
BIG_D, BIG_N, BIG_BATCH, BIG_L1, BIG_LR = 1024, 16384, 65536, 1e-3, 1e-3
BIG_GT = 4096  # ground-truth features of its synthetic store
BIG_CHUNK_ROWS, BIG_CHUNKS, BIG_EPOCHS, BIG_RESURRECT = 2 * BIG_BATCH, 4, 2, 8
BIG_STEPS = BIG_EPOCHS * BIG_CHUNKS * BIG_CHUNK_ROWS // BIG_BATCH
BIG_SMALL_SHAPES = ((32, 64, 40), (64, 64, 128), (32, 96, 640),
                    (64, 32, 1024))  # (batch, n_feats, d)
# the big-SAE kernels run the batch in chunks under one 1 GiB workspace
# cap: 16,384 rows at 16,384 features for big_sae_fwd, 8,192 for
# big_sae_bwd; this batch takes 16,384 + 16,384 + 4,096 and
# 4 x 8,192 + 4,096
BIG_CHUNK_SHAPE = (36864, BIG_N, BIG_D)
# the chunked kernels at the ratio-16 width: 32 members x 8,192 features,
# 2 chunks of 16 members in the forwards' 1 GiB workspace, 4 chunks of 8
# in the backwards'
RATIO16_SHAPE = (N_MEMBERS, BATCH, 16 * D, D)  # (members, batch, n, d)
RATIO16_FWD_CHUNKS = 2
RATIO16_CHUNKS = 4
# phase 2's widths beyond the kernels' former limit (768): the LM widths
# up to the kernels' widest (MAX_D = 4096: gpt2-medium's and
# Pythia-410M's d_mlp); 1000 is not a multiple of 32 or of 8
WIDTHS = (1000, 1024, 2048, 3072, 4096)
# a chunked kernel's call may allocate the buffers its allowance lists
# (repeat_and_memory) plus this much for the caching allocator's rounding
MEM_SLACK = 8 * 2**20
BIG_N_DEAD = 20
# ReLU mask flips: a pre-activation within rounding of 0 (the two sides
# sum its d products in other orders) can flip its mask — at most one flip
# per million codes is allowed (big_sae_bwd's l0, a count over B·n codes;
# sae_tied_bwd's masks, tied_bwd_flips), and a tied flip must lie within
# this share of the sums' worst-case rounding bound of 0 (the flips seen
# on the H100 lie within 1e-4 of it)
FLIPS_PER_CODE = 1e-6
FLIP_BOUND_SHARE = 1e-2
# The kernel path's 16-step run vs its autodiff replay (same init, batches
# and resurrection steps), ‖ΔW‖/‖W‖ per leaf after 16 Adam steps: the two
# paths' gradients differ by rounding (~1e-6), and Adam's early steps are
# ±lr·sign(g), so an element whose gradient lies within rounding of 0 can
# step the other way; a kernel fault moves whole rows.
REL_FRO_BIG_REPLAY = 1e-3
# c_totals over 8 steps (sums of 65,536 codes per step in other orders)
# and the worst-loss buffer (per-row MSEs of slightly different weights)
# just before each resurrection
RTOL_BIG_CTOTALS = 1e-3
RTOL_BIG_WORST = 1e-4
# the kernel step vs the autodiff step side by side from one init: the
# per-step metrics (the JAX package's own fused-vs-autodiff bound)
RTOL_BIG_STEP = 1e-4
# outputs that count ReLU masks: a flipped mask moves them by a count
MASK_COUNTS = ("activity", "l0", "l0_untied", "l0_tied")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def sass_count(lib: Path, opcode: str) -> int:
    """How many instructions of ``opcode`` the SASS of a built library
    holds (cuobjdump --dump-sass)."""
    from sparse_coding_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib)],
                          check=True, capture_output=True, text=True,
                          timeout=300).stdout
    return len(re.findall(rf"\b{opcode}\b", sass))


def sync() -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(label: str, got, ref, rtol: float, atol: float = 0.0) -> dict:
    """|got − ref|max against atol + rtol·max|ref|; raises on a miss or a
    non-finite value. Returns the errors."""
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        raise AssertionError(f"{label}: non-finite values")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    bound = atol + rtol * scale
    if not err <= bound:
        raise AssertionError(f"{label}: max abs err {err:.3e} > {bound:.3e} "
                             f"(rtol {rtol}, atol {atol}, max|ref| "
                             f"{scale:.3e})")
    return {"max_abs_err": err, "max_rel_err": err / scale if scale else 0.0,
            "tol": bound}


def is_mask_count(field: str) -> bool:
    return field.split("_masked")[0] in MASK_COUNTS


# --- phase 2: kernels --------------------------------------------------------

def make_inputs(gen: torch.Generator, n_members: int, batch: int,
                n_feats: int, d: int, x=None) -> dict:
    """Kernel inputs on the card: glorot encoders and decoders, small
    biases, an L1 grid, a masked-tied coefficient mask of mixed sizes, and
    mid-training Adam states (so an update is not just the sign of the
    gradient, which a rounding-level gradient could flip)."""
    dev = torch.device(DEV)
    lim = math.sqrt(6.0 / (n_feats + d))
    big = (n_members, n_feats, d)
    on = dict(generator=gen, device=gen.device)  # draws where gen lives
    glorot = lambda: (torch.rand(big, **on) * 2 - 1) * lim
    if x is None:
        x = torch.randn((batch, d), **on) / math.sqrt(d)
    g_scale = 1e-4
    grad = lambda: torch.randn(big, **on) * g_scale
    second = lambda shape: (torch.rand(shape, **on) + 0.5) * g_scale ** 2
    count = torch.full((n_members,), 100, dtype=torch.int32)
    b1, b2 = 0.9, 0.999
    c = count.float() + 1
    # member m keeps the first n / (1 + m % 4) features
    sizes = n_feats // (1 + torch.arange(n_members) % 4)
    inp = {
        "e": glorot(), "x": x.float(),
        "bias": (torch.rand((n_members, n_feats), **on) - 0.5).mul(0.02),
        "alphas": torch.logspace(-4, -2, n_members),
        "dw": grad(), "mu": grad(), "nu": second(big),
        "mu_b": torch.randn((n_members, n_feats), **on) * g_scale,
        "nu_b": second((n_members, n_feats)),
        "lrs": torch.full((n_members,), 1e-3),
        "bc1": 1.0 - torch.tensor(b1) ** c,
        "bc2": 1.0 - torch.tensor(b2) ** c,
        "dec": glorot(), "dwn": grad(), "mu_d": grad(), "nu_d": second(big),
        "cm": (torch.arange(n_feats)[None, :] < sizes[:, None]).float(),
    }
    return {k: v.to(dev).contiguous() for k, v in inp.items()}


def bwd_pairs(got, ref, grads: tuple, suffix: str = "") -> dict:
    """The comparisons of one backward kernel's outputs (weight grads, db,
    activity, loss4)."""
    k = len(grads)
    pairs = {g + suffix: (got[i], ref[i], RTOL_GRAD, 0.0)
             for i, g in enumerate(grads)}
    pairs.update({
        "db" + suffix: (got[k], ref[k], RTOL_GRAD, 0.0),
        "activity" + suffix: (got[k + 1], ref[k + 1], 0.0, ACT_COUNT_TOL),
        "loss4" + suffix: (got[k + 2][:, :2], ref[k + 2][:, :2], RTOL_EXACT,
                           0.0),
        "l0" + suffix: (got[k + 2][:, 2], ref[k + 2][:, 2], RTOL_GRAD, 0.0),
        "grad_sq" + suffix: (got[k + 2][:, 3], ref[k + 2][:, 3], RTOL_GRAD,
                             0.0)})
    return pairs


def loss_pairs(got_l, ref_l) -> dict:
    return {f"loss_{k}": (got_l[k], ref_l[k],
                          RTOL_GRAD if k == "l0" else RTOL_EXACT, 0.0)
            for k in ("mse", "l1", "l0")}


def check_kernels(inp: dict, tag: str) -> dict:
    """Every kernel and contract against its plain version on ``inp``; the
    tied dW and db (sae_tied_bwd, K1, K3) through tied_bwd_flips."""
    from sparse_coding_tpu_torch.ops import fused_sae as fs
    from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

    e, dec, x, bias, al, cm = (inp[k] for k in ("e", "dec", "x", "bias",
                                                 "alphas", "cm"))
    batch = x.shape[0]
    out = {}

    def cmp(name, pairs, flips=None):
        errs = {}
        for field, (got, ref, rtol, atol) in pairs.items():
            errs[field] = compare(f"{tag}:{name}.{field}", got, ref, rtol,
                                  atol)
        worst = max(v["max_rel_err"] for k, v in errs.items()
                    if not is_mask_count(k))
        out[name] = {**errs, **(flips or {})}
        log(f"  {tag} {name}: ok, worst rel err {worst:.2e}"
            + (" (dW and db with their flips above)" if flips else ""))

    def tied_flips(name, got_dw_db, ref_dw_db, r, mask, sfx):
        """tied_bwd_flips' reading of one tied dW and db: its comparisons
        (dw_no_flip<sfx>, ...) and, under flips<sfx>, its counts."""
        read = tied_bwd_flips(e, bias, al, x, r, mask, got_dw_db, ref_dw_db,
                              f"{tag} {name}{sfx}")
        return {**{k + sfx: v for k, v in read.items()
                   if isinstance(v, dict)},
                "flips" + sfx: {k: v for k, v in read.items()
                                if not isinstance(v, dict)}}

    # tied fwd/bwd, unmasked and with the masked family's coef_mask; the
    # bwd kernel and its plain version get the SAME residual
    r_ref = ft.sae_tied_fwd_plain(e, bias, x)
    rm_ref = ft.sae_tied_fwd_plain(e, bias, x, cm)
    cmp("sae_tied_fwd", {
        "r": (ft.sae_tied_fwd(e, bias, x), r_ref, RTOL_EXACT, 0.0),
        "r_masked": (ft.sae_tied_fwd(e, bias, x, cm), rm_ref, RTOL_EXACT,
                     0.0)})
    pairs, flips = {}, {}
    for r, mask, sfx in ((r_ref, None, ""), (rm_ref, cm, "_masked")):
        got = ft.sae_tied_bwd(e, bias, al, x, r, mask)
        ref = ft.sae_tied_bwd_plain(e, bias, al, x, r, mask)
        pairs.update(bwd_pairs(got, ref, ("dw",), sfx))
        del pairs["dw" + sfx], pairs["db" + sfx]
        flips.update(tied_flips("sae_tied_bwd", got[:2], ref[:2], r, mask,
                                sfx))
    cmp("sae_tied_bwd", pairs, flips)

    # untied fwd/bwd, then both adam_vjp
    ru_ref = ft.sae_untied_fwd_plain(e, dec, bias, x)
    cmp("sae_untied_fwd", {
        "r": (ft.sae_untied_fwd(e, dec, bias, x), ru_ref, RTOL_EXACT, 0.0)})
    cmp("sae_untied_bwd", bwd_pairs(
        ft.sae_untied_bwd(e, dec, bias, al, x, ru_ref),
        ft.sae_untied_bwd_plain(e, dec, bias, al, x, ru_ref), ("de", "dwn")))
    for name, pairs in adam_pairs(inp).items():
        cmp(name, pairs)
    args = (e, inp["dw"], inp["mu"], inp["nu"], inp["lrs"], inp["bc1"],
            inp["bc2"])
    uargs = (e, inp["dw"], inp["mu"], inp["nu"], dec, inp["dwn"],
             inp["mu_d"], inp["nu_d"], inp["lrs"], inp["bc1"], inp["bc2"])
    unames = ("e", "mu_e", "nu_e", "d", "mu_d", "nu_d", "un_sq")

    # the contracts
    for r, mask, sfx in ((r_ref, None, ""), (rm_ref, cm, " masked")):
        got = fs.fused_tied_sae_grads(e, bias, al, x, coef_mask=mask)
        ref = fs.fused_tied_sae_grads_plain(e, bias, al, x, coef_mask=mask)
        cmp("K1 fused_tied_sae_grads" + sfx, {
            **loss_pairs(got[0], ref[0]),
            "activity": (got[3], ref[3], 0.0, ACT_COUNT_TOL)},
            tied_flips("K1" + sfx, got[1:3], ref[1:3], r, mask, ""))

    k2 = (e, bias, inp["mu"], inp["nu"], inp["mu_b"], inp["nu_b"], al,
          inp["lrs"], inp["bc1"], inp["bc2"], x)
    got = fs.fused_tied_sae_train_step(*k2)
    ref = fs.fused_tied_sae_train_step_plain(*k2)
    names = ("e", "bias", "mu_e", "nu_e", "mu_b", "nu_b")
    cmp("K2 fused_tied_sae_train_step", {
        **loss_pairs(got[0], ref[0]),
        **{n: (g, rf, RTOL_GRAD, 0.0)
           for n, g, rf in zip(names, got[1:7], ref[1:7])},
        "activity": (got[7], ref[7], 0.0, ACT_COUNT_TOL)})

    bt = 256 if batch % 256 == 0 else 32
    ftile = 256 if e.shape[1] % 256 == 0 else 32
    for r, mask, sfx in ((r_ref, None, ""), (rm_ref, cm, " masked")):
        got = ft.tiled_tied_sae_grads(e, bias, al, x, bt, ftile,
                                      coef_mask=mask)
        ref = ft.tiled_tied_sae_grads_plain(e, bias, al, x, bt, ftile,
                                            coef_mask=mask)
        cmp("K3 tiled_tied_sae_grads" + sfx, {
            **loss_pairs(got[0], ref[0]),
            "activity": (got[3], ref[3], 0.0, ACT_COUNT_TOL),
            "grad_sq": (got[4], ref[4], RTOL_GRAD, 0.0)},
            tied_flips("K3" + sfx, got[1:3], ref[1:3], r, mask, ""))

    got = fs.fused_tied_adam_vjp_update(*args, ftile=32)
    ref = fs.fused_tied_adam_vjp_update_plain(*args, ftile=32)
    cmp("K4 fused_tied_adam_vjp_update", {
        n: (g, rf, RTOL_EXACT, 0.0)
        for n, g, rf in zip(("e", "mu", "nu", "un_sq"), got, ref)})

    got = fs.fused_untied_sae_grads(e, dec, bias, al, x)
    ref = fs.fused_untied_sae_grads_plain(e, dec, bias, al, x)
    cmp("K5 fused_untied_sae_grads", {
        **loss_pairs(got[0], ref[0]),
        **{n: (g, rf, RTOL_GRAD, 0.0)
           for n, g, rf in zip(("de", "dwn", "db"), got[1:4], ref[1:4])},
        "activity": (got[4], ref[4], 0.0, ACT_COUNT_TOL)})

    cmp("K6 fused_adam_vjp_update", {
        n: (g, rf, RTOL_EXACT, 0.0) for n, g, rf in zip(
            unames, fs.fused_adam_vjp_update(*uargs, ftile=32),
            fs.fused_adam_vjp_update_plain(*uargs, ftile=32))})

    got = ft.tiled_untied_sae_grads(e, dec, bias, al, x, bt, ftile)
    ref = ft.tiled_untied_sae_grads_plain(e, dec, bias, al, x, bt, ftile)
    cmp("K7 tiled_untied_sae_grads", {
        **loss_pairs(got[0], ref[0]),
        **{n: (g, rf, RTOL_GRAD, 0.0)
           for n, g, rf in zip(("de", "dwn", "db"), got[1:4], ref[1:4])},
        "activity": (got[4], ref[4], 0.0, ACT_COUNT_TOL),
        "grad_sq": (got[5], ref[5], RTOL_GRAD, 0.0)})
    sync()
    return out


def adam_pairs(inp: dict) -> dict:
    """The two Adam epilogues (fp32 moments; the tied one with its bias
    rows) against their plain versions on ``inp``, as compare's
    (got, ref, rtol, atol) pairs by kernel."""
    from sparse_coding_tpu_torch.ops import fused_sae as fs

    e, dec, bias = inp["e"], inp["dec"], inp["bias"]
    args = (e, inp["dw"], inp["mu"], inp["nu"], inp["lrs"], inp["bc1"],
            inp["bc2"])
    bias_grp = dict(bias=bias, db=inp["dw"][:, :, 0].contiguous(),
                    mu_b=inp["mu_b"], nu_b=inp["nu_b"])
    got = fs.sae_tied_adam_vjp(*args, **bias_grp)
    ref = fs.sae_tied_adam_vjp_plain(*args, **bias_grp)
    tied = {
        **{n: (g, rf, RTOL_EXACT, 0.0) for n, g, rf in zip(
            ("e", "mu", "nu", "un_sq"), got[:4], ref[:4])},
        **{n: (g, rf, RTOL_EXACT, 0.0) for n, g, rf in zip(
            ("bias", "mu_b", "nu_b"), got[4], ref[4])}}
    uargs = (e, inp["dw"], inp["mu"], inp["nu"], dec, inp["dwn"],
             inp["mu_d"], inp["nu_d"], inp["lrs"], inp["bc1"], inp["bc2"])
    unames = ("e", "mu_e", "nu_e", "d", "mu_d", "nu_d", "un_sq")
    untied = {n: (g, rf, RTOL_EXACT, 0.0) for n, g, rf in zip(
        unames, fs.sae_untied_adam_vjp(*uargs),
        fs.sae_untied_adam_vjp_plain(*uargs))}
    return {"sae_tied_adam_vjp": tied, "sae_untied_adam_vjp": untied}


def active_codes(inp: dict) -> dict:
    """The number of active (member, row, feature) codes of each family's
    forward on ``inp`` — what the sparse products of its kernels need."""
    from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

    e, dec, x, bias, al = (inp[k] for k in ("e", "dec", "x", "bias",
                                             "alphas"))
    tied = ft.sae_tied_bwd_plain(e, bias, al, x,
                                 ft.sae_tied_fwd_plain(e, bias, x))[2]
    untied = ft.sae_untied_bwd_plain(
        e, dec, bias, al, x, ft.sae_untied_fwd_plain(e, dec, bias, x))[3]
    return {"tied": int(tied.sum()), "untied": int(untied.sum())}


def bounds(inp: dict, nnz: dict) -> dict:
    """Least time the card could take for each kernel's work on ``inp``:
    max(bytes / HBM rate, fp32 ops / fp32 peak). Each input is read once
    and each output written once; the codes are sparse, so the products
    that involve them count only this data's active (member, row,
    feature) codes (``nnz``, per family)."""
    n_m, n, d = inp["e"].shape
    b = inp["x"].shape[0]
    f4 = 4
    big = n_m * n * d
    enc = 2.0 * n_m * b * n * d  # pre = x·Wᵀ, dense
    act = {k: 2.0 * v * d for k, v in nnz.items()}  # one product, active
    work = {
        "sae_tied_fwd": (
            enc + act["tied"] + big * 3,
            f4 * (b * d + big + n_m * n + n_m * b * d)),
        "sae_tied_bwd": (
            enc + 3 * act["tied"] + big * 3,
            f4 * (b * d + 2 * n_m * b * d + 2 * big + 3 * n_m * n + n_m)),
        "sae_tied_adam_vjp": (
            24.0 * big, f4 * (7 * big + 3 * n_m)),
        "sae_untied_fwd": (
            enc + act["untied"] + big * 3,
            f4 * (b * d + 2 * big + n_m * n + n_m * b * d)),
        "sae_untied_bwd": (
            enc + 3 * act["untied"] + big * 3,
            f4 * (b * d + 2 * n_m * b * d + 4 * big + 3 * n_m * n + n_m)),
        "sae_untied_adam_vjp": (
            36.0 * big, f4 * (14 * big + 3 * n_m)),
    }
    out = {}
    for name, (ops, nbytes) in work.items():
        t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
        out[name] = {"bound_ms": 1e3 * max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes", "flops": ops, "bytes": nbytes}
    return out


def time_kernels(inp: dict) -> dict:
    from sparse_coding_tpu_torch.ops import fused_sae as fs
    from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

    e, dec, x, bias, al = (inp[k] for k in ("e", "dec", "x", "bias",
                                             "alphas"))
    r = ft.sae_tied_fwd_plain(e, bias, x)
    ru = ft.sae_untied_fwd_plain(e, dec, bias, x)
    adam = (e, inp["dw"], inp["mu"], inp["nu"], inp["lrs"], inp["bc1"],
            inp["bc2"])
    uadam = (e, inp["dw"], inp["mu"], inp["nu"], dec, inp["dwn"],
             inp["mu_d"], inp["nu_d"], inp["lrs"], inp["bc1"], inp["bc2"])
    pairs = {
        "sae_tied_fwd": (lambda: ft.sae_tied_fwd(e, bias, x),
                         lambda: ft.sae_tied_fwd_plain(e, bias, x), 5),
        "sae_tied_bwd": (lambda: ft.sae_tied_bwd(e, bias, al, x, r),
                         lambda: ft.sae_tied_bwd_plain(e, bias, al, x, r), 5),
        "sae_tied_adam_vjp": (lambda: fs.sae_tied_adam_vjp(*adam),
                              lambda: fs.sae_tied_adam_vjp_plain(*adam), 20),
        "sae_untied_fwd": (
            lambda: ft.sae_untied_fwd(e, dec, bias, x),
            lambda: ft.sae_untied_fwd_plain(e, dec, bias, x), 5),
        "sae_untied_bwd": (
            lambda: ft.sae_untied_bwd(e, dec, bias, al, x, ru),
            lambda: ft.sae_untied_bwd_plain(e, dec, bias, al, x, ru), 5),
        "sae_untied_adam_vjp": (
            lambda: fs.sae_untied_adam_vjp(*uadam),
            lambda: fs.sae_untied_adam_vjp_plain(*uadam), 20),
    }
    return time_pairs(pairs)


def time_pairs(pairs: dict) -> dict:
    """Each {name: (kernel, plain, iters)} timed in turns — plain, kernel,
    kernel, plain — keeping the faster window of each."""
    out = {}
    for name, (kern, plain, iters) in pairs.items():
        p1 = time_ms(plain, iters)
        k1 = time_ms(kern, iters)
        k2 = time_ms(kern, iters)
        p2 = time_ms(plain, iters)
        out[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                     "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2],
                     "library_ms": None}
        log(f"  {name}: kernel {min(k1, k2):.3f} ms, plain "
            f"{min(p1, p2):.3f} ms")
    return out


def bound_shares(timing: dict, bnds: dict, names, note: str = "") -> dict:
    """Each kernel of ``names``: its ms beside its bound ms, and the share
    of its bound it reaches (bound / ms), logged."""
    out = {}
    for name in names:
        ms, b = timing[name]["ms"], bnds[name]
        out[name] = {"ms": ms, "bound_ms": b["bound_ms"],
                     "bound_by": b["bound_by"], "share": b["bound_ms"] / ms}
        log(f"  {name}{note}: {ms:.3f} ms against its bound "
            f"{b['bound_ms']:.3f} ms ({b['bound_by']}): "
            f"{100 * b['bound_ms'] / ms:.1f}% of it")
    return out


def part_launches(tied: bool, calls: int,
                  shape=(N_MEMBERS, BATCH, N_FEATS)) -> dict:
    """The part launches of a family's chunked kernels — its forward's and
    backward's — over ``calls`` calls of each at ``shape`` (members, batch,
    n): the norms (and the backwards' loss) once a call, the products (and
    the backwards' sums) once per chunk of each kernel's schedule."""
    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

    once = ("sae_tied_fwd_norms", "sae_tied_bwd_norms", "sae_tied_bwd_loss",
            "sae_untied_fwd_norms", "sae_untied_bwd_norms",
            "sae_untied_bwd_loss")
    kernels = (((_build.TIED_FWD_PARTS, ft.fwd_chunks),
                (_build.TIED_BWD_PARTS, ft.bwd_chunks)) if tied else
               ((_build.UNTIED_FWD_PARTS, ft.fwd_chunks),
                (_build.UNTIED_BWD_PARTS, ft.bwd_chunks)))
    out = {}
    for parts, chunks in kernels:
        n_chunks = len(chunks(*shape))
        out.update({k: calls * (1 if k in once else n_chunks)
                    for k in parts})
    return out


def time_parts(parts: dict, note: str = "") -> dict:
    """Each launch of ``parts`` ({name: (launch, FLOPs)}) timed alone
    (CUDA events, 5 launches), with the products' TFLOP/s."""
    times = {}
    for name, (fn, flops) in parts.items():
        ms = time_ms(fn, 5)
        times[name] = {"ms": ms, "tflops": flops / ms / 1e9}
        log(f"  {name}{note}: {ms:.3f} ms"
            + (f", {flops / ms / 1e9:.1f} TFLOP/s" if flops else ""))
    return times


def repeat_and_memory(label: str, call, plain, allowed: int,
                      what: str) -> dict:
    """Two calls of ``call`` give the same bits, and one call's peak memory
    stays within ``allowed`` bytes (the buffers ``what`` lists) plus
    MEM_SLACK; the plain version's peak is recorded beside it."""
    first, again = call(), call()
    if isinstance(first, torch.Tensor):
        first, again = (first,), (again,)
    same = [torch.equal(u, v) for u, v in zip(first, again)]
    del first, again
    if not all(same):
        raise AssertionError(f"{label}: two calls differ ({same})")
    allowed += MEM_SLACK
    mem = {"kernel": peak_bytes(call), "plain": peak_bytes(plain),
           "kernel_allowed": allowed}
    log(f"  {label}: two calls bit-identical; peak memory of one call "
        f"{mem['kernel'] / 2**20:.1f} MiB (allowed {allowed / 2**20:.1f}: "
        f"{what}), plain {mem['plain'] / 2**20:.1f} MiB")
    if mem["kernel"] > allowed:
        raise AssertionError(f"{label} allocated {mem['kernel']} bytes at "
                             f"its peak (> {allowed})")
    return {"bit_identical": True, "peak_bytes": mem}


def fwd_repeat_and_memory(e, bias, x, tag: str, dec=None, cm=None) -> dict:
    """:func:`repeat_and_memory` of a forward on these inputs — the untied
    one given ``dec``, else the tied one (with ``cm``, if given) —, allowed
    its output, the normalized dictionary (Ŵ or Wn) and its workspace."""
    from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

    n_m, n, d = e.shape
    b = x.shape[0]
    chunks = ft.fwd_chunks(n_m, b, n)
    ws = max((mh - ml) * (bh - bl) for ml, mh, bl, bh in chunks) * n
    if dec is None:
        name = "sae_tied_fwd" + ("" if cm is None else " masked")
        call = lambda: ft.sae_tied_fwd(e, bias, x, cm)
        plain = lambda: ft.sae_tied_fwd_plain(e, bias, x, cm)
    else:
        name = "sae_untied_fwd"
        call = lambda: ft.sae_untied_fwd(e, dec, bias, x)
        plain = lambda: ft.sae_untied_fwd_plain(e, dec, bias, x)
    out = repeat_and_memory(
        f"{tag} {name} ({len(chunks)} chunks)", call, plain,
        4 * (n_m * b * d + n_m * n * d + ws),
        f"output, {'Wn' if dec is not None else 'Ŵ'}, workspace "
        f"{ws * 4 / 2**20:.0f} MiB")
    return {**out, "chunks": len(chunks)}


def fwd_extras(inp: dict, tied: bool) -> dict:
    """A forward at the main shape: the repeat and memory checks of
    :func:`fwd_repeat_and_memory` (the tied one with and without the
    coef_mask), and each of its launches timed alone on its one chunk."""
    from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

    e, dec, x, bias, cm = (inp[k] for k in ("e", "dec", "x", "bias", "cm"))
    if tied:
        out = fwd_repeat_and_memory(e, bias, x, "main")
        out["masked"] = fwd_repeat_and_memory(e, bias, x, "main", cm=cm)
        name = "sae_tied_fwd"
    else:
        out = fwd_repeat_and_memory(e, bias, x, "main", dec=dec)
        name = "sae_untied_fwd"
    if out["chunks"] != 1:
        raise AssertionError(f"main shape: {name} chunks {out['chunks']}")
    times = time_parts(ft.one_chunk_launches(name, e, bias, x, decoder=dec))
    per_call = sum(v["ms"] for v in times.values())
    log(f"  one chunk: {name}'s launches sum to {per_call:.2f} ms a call")
    torch.cuda.empty_cache()
    return {**out, "parts": times, "parts_sum_ms": per_call}


def check_chunked(gen: torch.Generator, x: torch.Tensor, shape: tuple,
                  want_chunks: dict, tag: str) -> dict:
    """The chunked ensemble kernels against their plain versions at
    ``shape`` (members, batch, n, d), which the real 1 GiB workspaces take
    in ``want_chunks`` member chunks; the launches must show them. The
    untied forward's residual feeds both untied backwards; the tied
    backward and its plain version get the plain tied forward's residual,
    with and without a coef_mask. The forwards (the tied one with and
    without a coef_mask) and the tied backward also repeat bitwise and
    stay within their memory allowances."""
    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

    n_m, b, n, d = shape
    chunks = {"fwd": len(ft.fwd_chunks(n_m, b, n)),
              "bwd": len(ft.bwd_chunks(n_m, b, n))}
    if chunks != want_chunks:
        raise AssertionError(f"{tag}: chunks {chunks}")
    lim = math.sqrt(6.0 / (n + d))
    on = dict(generator=gen, device=gen.device)
    glorot = lambda: ((torch.rand((n_m, n, d), **on) * 2 - 1)
                      * lim).to(DEV)
    e, dec = glorot(), glorot()
    bias = ((torch.rand((n_m, n), **on) - 0.5) * 0.02).to(DEV)
    al = torch.logspace(-4, -2, n_m).to(DEV)
    _build.reset_launches()
    r = ft.sae_untied_fwd(e, dec, bias, x)
    got = ft.sae_untied_bwd(e, dec, bias, al, x, r)
    sync()
    want = part_launches(False, 1, (n_m, b, n))
    launches = {k: _build.LAUNCHES[k] for k in want}
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, expected "
                             f"{want}")
    r_err = compare(f"{tag}:sae_untied_fwd.r", r,
                    ft.sae_untied_fwd_plain(e, dec, bias, x), RTOL_EXACT)
    log(f"  {tag} sae_untied_fwd ({n_m}x{b}x{n}x{d}, {chunks['fwd']} "
        f"chunks): ok, rel err {r_err['max_rel_err']:.2e}")
    ref = ft.sae_untied_bwd_plain(e, dec, bias, al, x, r)
    errs = {field: compare(f"{tag}:sae_untied_bwd.{field}", g, rf, rtol,
                           atol)
            for field, (g, rf, rtol, atol) in bwd_pairs(
                got, ref, ("de", "dwn")).items()}
    worst = max(v["max_rel_err"] for k, v in errs.items()
                if not is_mask_count(k))
    log(f"  {tag} sae_untied_bwd ({n_m}x{b}x{n}x{d}, {chunks['bwd']} "
        f"chunks): ok, worst rel err {worst:.2e}")
    del r, got, ref
    torch.cuda.empty_cache()
    fwd = fwd_repeat_and_memory(e, bias, x, tag, dec=dec)
    del dec
    torch.cuda.empty_cache()

    # member m keeps the first n / (1 + m % 4) features, as make_inputs
    cm = (torch.arange(n)[None, :]
          < (n // (1 + torch.arange(n_m) % 4))[:, None]).float().to(DEV)
    tied, tied_fwd = {}, {}
    for mask, sfx in ((None, ""), (cm, "_masked")):
        rt = ft.sae_tied_fwd_plain(e, bias, x, mask)
        _build.reset_launches()
        rk = ft.sae_tied_fwd(e, bias, x, mask)
        got = ft.sae_tied_bwd(e, bias, al, x, rt, mask)
        sync()
        want = part_launches(True, 1, (n_m, b, n))
        launches = {k: _build.LAUNCHES[k] for k in want}
        if launches != want:
            raise AssertionError(f"{tag}: tied launches {launches}, "
                                 f"expected {want}")
        tied_fwd[f"r{sfx}"] = compare(f"{tag}:sae_tied_fwd.r{sfx}", rk,
                                      rt, RTOL_EXACT)
        log(f"  {tag} sae_tied_fwd{sfx} ({n_m}x{b}x{n}x{d}, "
            f"{chunks['fwd']} chunks): ok, rel err "
            f"{tied_fwd[f'r{sfx}']['max_rel_err']:.2e}")
        del rk
        tied_fwd[f"repeat_memory{sfx}"] = fwd_repeat_and_memory(
            e, bias, x, tag, cm=mask)
        ref = ft.sae_tied_bwd_plain(e, bias, al, x, rt, mask)
        # dW and db row by row in tied_bwd_flips, the rest here
        pairs = bwd_pairs(got, ref, ("dw",), sfx)
        del pairs["dw" + sfx], pairs["db" + sfx]
        errs_t = {field: compare(f"{tag}:sae_tied_bwd.{field}", g, rf,
                                 rtol, atol)
                  for field, (g, rf, rtol, atol) in pairs.items()}
        worst = max(v["max_rel_err"] for k, v in errs_t.items()
                    if not is_mask_count(k))
        log(f"  {tag} sae_tied_bwd{sfx} ({n_m}x{b}x{n}x{d}, "
            f"{chunks['bwd']} chunks): ok, worst rel err {worst:.2e} "
            "(activity, losses)")
        flips = tied_bwd_flips(e, bias, al, x, rt, mask, got, ref,
                               f"{tag}{sfx}")
        tied.update({**errs_t, f"flips{sfx}": flips})
        del got, ref
        torch.cuda.empty_cache()
        if mask is None:
            tied_mem = tied_bwd_repeat_and_memory(e, bias, al, x, rt, None,
                                                  tag)
        del rt
        torch.cuda.empty_cache()
    del e
    torch.cuda.empty_cache()
    return {"sae_untied_fwd": {"r": r_err, **fwd}, "sae_untied_bwd": errs,
            "sae_tied_fwd": tied_fwd, "sae_tied_bwd": {**tied, **tied_mem},
            "chunks": chunks}


def tied_bwd_flips(e, bias, al, x, r, cm, got, ref, tag: str,
                   total_batch=None) -> dict:
    """sae_tied_bwd's dW and db (``got``) against the plain version's
    (``ref``), with its ReLU mask flips counted and bounded. A
    pre-activation within rounding of 0 can land on the other side of 0 in
    the kernel, whose sums run in another order than cuBLAS's: a flip,
    which moves that feature's dW row by dpre·x and its db by dpre — more
    than RTOL_GRAD of max|dW| when it hits a high-alpha member among the
    537M codes at the ratio-16 width. The kernel's masks come from its
    codes launch on these inputs (the launch the call makes, on its own Ŵ).
    Checked:

    - at most FLIPS_PER_CODE flips per code (at least one allowed);
    - each flip within FLIP_BOUND_SHARE of the rounding bound of 0: each
      side's pre-activation is within (d+1)·2⁻²⁴·S of the exact one,
      S = Σ_j|x_j·ŵ_j| + |b|, and the two sides' Ŵ differ by as much
      again, so 3·(d+1)·2⁻²⁴·S;
    - dW and db of every (member, feature) with no flip against the plain
      version within RTOL_GRAD;
    - dW and db of every (member, feature) against the plain version with
      each flipped code's terms moved to the kernel's side (±dpre·x_b and
      coef·Δc·r_b in its dW row, ±dpre in its db) within RTOL_GRAD.

    The codes launch runs once more on the plain version's Ŵ (torch's row
    norms), and its flips are counted beside the kernel's: if they vanish,
    the flips come from the norm pass; if not, from the products' order."""
    from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

    n_m, n, d = e.shape
    b = x.shape[0]
    w = e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True),
                        min=1e-8)
    pre = torch.matmul(x, w.transpose(1, 2)) + bias[:, None, :]
    want = pre > 0
    if cm is not None:
        want &= cm[:, None, :] > 0
    w_k = torch.empty_like(e)
    c_k = torch.empty((n_m, b, n), dtype=torch.float32, device=DEV)
    ft.tied_bwd_norms(e, w_k)
    w_diff = int((w_k != w).sum())
    ft.tied_bwd_codes(x, w_k, bias, cm, c_k)
    mm, bb, ff = ((c_k > 0) != want).nonzero().unbind(1)
    c_flip = c_k[mm, bb, ff]
    ft.tied_bwd_codes(x, w, bias, cm, c_k)
    torch_w_flips = int(((c_k > 0) != want).sum())
    del c_k, w_k, want
    flips = len(mm)
    allowed = max(1.0, FLIPS_PER_CODE * n_m * b * n)
    s = (x[bb].abs() * w[mm, ff].abs()).sum(dim=1) + bias[mm, ff].abs()
    p_flip = pre[mm, bb, ff]
    del pre
    ratio = p_flip.abs() / (3 * (d + 1) * 2.0**-24 * s)
    worst = float(ratio.max()) if flips else 0.0
    log(f"  {tag} sae_tied_bwd: {flips} ReLU mask flips of {n_m * b * n} "
        f"(allowed {allowed:.0f}), the farthest from 0 at {worst:.2e} of "
        f"its rounding bound (allowed {FLIP_BOUND_SHARE}); on torch's Ŵ "
        f"{torch_w_flips} flips (the kernel's Ŵ differs from torch's in "
        f"{w_diff} of {n_m * n * d} elements)")
    if flips > allowed:
        raise AssertionError(f"{tag}: sae_tied_bwd flipped {flips} ReLU "
                             f"masks (> {allowed:.0f})")
    if not worst <= FLIP_BOUND_SHARE:
        raise AssertionError(f"{tag}: sae_tied_bwd flipped a ReLU mask "
                             f"{worst:.2e} of the rounding bound from 0 "
                             f"(> {FLIP_BOUND_SHARE})")
    clean = torch.ones((n_m, n), dtype=torch.bool, device=DEV)
    clean[mm, ff] = False
    errs = {f"{f}_no_flip": compare(
        f"{tag}:sae_tied_bwd.{f} (features with no flip)", g[clean],
        rf[clean], RTOL_GRAD) for f, g, rf in (("dw", got[0], ref[0]),
                                               ("db", got[1], ref[1]))}
    # the kernel's side of each flip: +1 where only the kernel's mask is
    # set, −1 where only the plain version's is
    sign = (c_flip > 0).float() * 2 - 1
    tb = total_batch or b  # a data shard's normalizer: the global batch
    coef = 2.0 / (tb * d)
    g_flip = (coef * (r[mm, bb] * w[mm, ff]).sum(dim=1) + al[mm] / tb) * sign
    dc = c_flip - torch.relu(p_flip)
    dw = ref[0].clone().index_put_(
        (mm, ff), g_flip[:, None] * x[bb] + (coef * dc)[:, None] * r[mm, bb],
        accumulate=True)
    db = ref[1].clone().index_put_((mm, ff), g_flip, accumulate=True)
    errs.update({f"{f}_flips_moved": compare(
        f"{tag}:sae_tied_bwd.{f} (the flips' terms moved)", g, rf, RTOL_GRAD)
        for f, g, rf in (("dw", got[0], dw), ("db", got[1], db))})
    del dw, db, clean
    torch.cuda.empty_cache()
    log(f"  {tag} sae_tied_bwd vs the plain version: with no flip dW "
        f"{errs['dw_no_flip']['max_rel_err']:.2e}, db "
        f"{errs['db_no_flip']['max_rel_err']:.2e}; with the flips' terms "
        f"moved dW {errs['dw_flips_moved']['max_rel_err']:.2e}, db "
        f"{errs['db_flips_moved']['max_rel_err']:.2e}")
    return {"count": flips, "allowed": allowed, "worst_of_bound": worst,
            "torch_w_flips": torch_w_flips, "w_elements_differing": w_diff,
            **errs}


def tied_bwd_repeat_and_memory(e, bias, al, x, r, cm, tag: str) -> dict:
    """:func:`repeat_and_memory` of sae_tied_bwd on these inputs, allowed
    its outputs, the normalized dictionary, the per-feature sums and its
    workspace."""
    from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

    n_m, n, d = e.shape
    b = x.shape[0]
    chunks = ft.bwd_chunks(n_m, b, n)
    ws = 2 * max((mh - ml) * (bh - bl) for ml, mh, bl, bh in chunks) * n
    args = (e, bias, al, x, r, cm)
    out = repeat_and_memory(
        f"{tag} sae_tied_bwd ({len(chunks)} chunks)",
        lambda: ft.sae_tied_bwd(*args),
        lambda: ft.sae_tied_bwd_plain(*args),
        4 * (2 * n_m * n * d + 3 * n_m * n + 4 * n_m + ws),
        f"outputs, W, sums, workspace {ws * 4 / 2**20:.0f} MiB")
    return {**out, "chunks": len(chunks)}


def tied_bwd_extras(inp: dict) -> dict:
    """sae_tied_bwd at the main shape: the repeat and memory checks of
    :func:`tied_bwd_repeat_and_memory`, and each of its launches timed
    alone on its one chunk (CUDA events, 5 launches), with the products'
    TFLOP/s."""
    from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

    e, x, bias, al = (inp[k] for k in ("e", "x", "bias", "alphas"))
    r = ft.sae_tied_fwd_plain(e, bias, x).contiguous()
    out = tied_bwd_repeat_and_memory(e, bias, al, x, r, None, "main")
    out["flips"] = tied_bwd_flips(
        e, bias, al, x, r, None, ft.sae_tied_bwd(e, bias, al, x, r),
        ft.sae_tied_bwd_plain(e, bias, al, x, r), "main")
    if out["chunks"] != 1:
        raise AssertionError(f"main shape: tied backward chunks "
                             f"{out['chunks']}")
    times = time_parts(ft.one_chunk_launches("sae_tied_bwd", e, bias, x,
                                             alphas=al, resid=r))
    per_call = sum(v["ms"] for v in times.values())
    log(f"  one chunk: the tied backward's launches sum to {per_call:.2f} "
        "ms a call")
    torch.cuda.empty_cache()
    return {**out, "parts": times, "parts_sum_ms": per_call}


def untied_bwd_extras(inp: dict) -> dict:
    """sae_untied_bwd at the main shape: two calls give the same bits; one
    call's peak memory beside the plain version's (the kernel's must stay
    within its outputs, the row norms, the workspace and the stated
    slack); and each of its launches timed alone (CUDA events, 5
    launches), with the products' TFLOP/s."""
    from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

    e, dec, x, bias, al = (inp[k] for k in ("e", "dec", "x", "bias",
                                             "alphas"))
    n_m, n, d = e.shape
    b = x.shape[0]
    ru = ft.sae_untied_fwd_plain(e, dec, bias, x).contiguous()
    args = (e, dec, bias, al, x, ru)
    chunks = ft.bwd_chunks(n_m, b, n)
    ws = 2 * max((mh - ml) * (bh - bl) for ml, mh, bl, bh in chunks) * n
    out = repeat_and_memory(
        "sae_untied_bwd", lambda: ft.sae_untied_bwd(*args),
        lambda: ft.sae_untied_bwd_plain(*args),
        4 * (2 * n_m * n * d + 4 * n_m * n + 4 * n_m + ws),
        f"outputs, norms, workspace {ws * 4 / 2**20:.0f} MiB")

    if len(chunks) != 1:
        raise AssertionError(f"main shape: chunks {chunks}")
    times = time_parts(ft.one_chunk_launches(
        "sae_untied_bwd", e, bias, x, decoder=dec, alphas=al, resid=ru))
    per_call = sum(v["ms"] for v in times.values())
    log(f"  one chunk: the backward's launches sum to {per_call:.2f} ms a "
        "call")
    torch.cuda.empty_cache()
    return {**out, "chunks": len(chunks), "parts": times,
            "parts_sum_ms": per_call}


# --- phases 3-5: main paths and their autodiff references ---------------------

def write_store(folder: Path, n_rows: int, seed: int,
                rows_per_chunk: int = ROWS_PER_CHUNK) -> None:
    """Synthetic activations with the repo's generator, written by the
    port's ChunkWriter (bfloat16 on disk, as harvests write them)."""
    from sparse_coding_tpu_torch.data.chunk_store import ChunkWriter
    from sparse_coding_tpu_torch.data.synthetic import RandomDatasetGenerator

    g = torch.Generator(DEV).manual_seed(seed)
    gen = RandomDatasetGenerator.create(g, D, 2 * N_FEATS, 32, 0.999)
    w = ChunkWriter(folder, D, chunk_size_gb=rows_per_chunk * D * 2 / 2**30,
                    dtype="bfloat16")
    if w.rows_per_chunk != rows_per_chunk:
        raise AssertionError(f"rows per chunk {w.rows_per_chunk}")
    for lo in range(0, n_rows, 8192):
        w.add(gen.batch(g, min(8192, n_rows - lo)))
    w.finalize()


def read_metrics(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines()]


def main_path(store: Path, out_dir: Path, l1_values, n_steps: int,
              tied: bool) -> dict:
    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.train.basic_sweep import basic_l1_sweep
    from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts

    _build.reset_launches()
    sync()
    t0 = time.perf_counter()
    dicts = basic_l1_sweep(store, out_dir, l1_values, dict_ratio=RATIO,
                           batch_size=BATCH, lr=LR, n_epochs=1, seed=SEED,
                           tied=tied, device=DEV)
    sync()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    log(f"  basic_l1_sweep(tied={tied}): {wall:.2f} s wall, launches "
        f"{launches}")
    ours = TIED_KERNELS if tied else UNTIED_KERNELS
    want = {name: n_steps if name in ours else 0 for name in _build.LAUNCHES}
    want.update(part_launches(tied, n_steps))
    if launches != want:
        raise AssertionError(f"launches on the main path {launches}, "
                             f"expected {want} (one per step of this "
                             "family's kernels and its chunked kernels' "
                             "parts per chunk, none of the other's)")

    recs = read_metrics(out_dir / "metrics.jsonl")
    if [r["step"] for r in recs] != list(range(100, n_steps + 1, 100)):
        raise AssertionError(f"metrics.jsonl: steps "
                             f"{[r['step'] for r in recs]}")
    first, last = recs[0], recs[-1]
    for rec in recs:
        bad = [k for k, v in rec.items() if isinstance(v, float)
               and not math.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite metrics at step "
                                 f"{rec['step']}: {bad}")
    mse = {r["step"]: [r[f"l1={l1:.2e}/mse"] for l1 in l1_values]
           for r in recs}
    acts_per_s = ((last["step"] - first["step"]) * BATCH
                  / (last["ts"] - first["ts"]))
    log(f"  mse at steps {list(mse)}: member 0 "
        f"{[f'{m[0]:.4e}' for m in mse.values()]}, member "
        f"{len(l1_values) - 1} {[f'{m[-1]:.4e}' for m in mse.values()]}; "
        f"{acts_per_s:.0f} acts/s (steps {first['step']}-{last['step']}, "
        "data loading included)")

    # eval.json: finite, and the L1 grid orders the members — the weakest
    # penalty reconstructs best and keeps the most features active
    evals = json.loads((out_dir / "epoch_0" / "eval.json").read_text())
    if len(evals) != len(l1_values) or not all(
            math.isfinite(s["fvu"]) and math.isfinite(s["l0"])
            and s["fvu"] >= 0.0 for s in evals):
        raise AssertionError(f"eval.json: {evals}")
    if not (evals[0]["fvu"] < min(1.0, evals[-1]["fvu"])
            and evals[0]["l0"] > evals[-1]["l0"]):
        raise AssertionError(f"eval.json: the L1 grid does not order fvu "
                             f"and l0: {evals[0]} vs {evals[-1]}")
    loaded = load_learned_dicts(out_dir / "epoch_0" / "learned_dicts.pkl")
    if len(loaded) != len(l1_values) or len(dicts) != len(l1_values):
        raise AssertionError("learned_dicts.pkl: wrong member count")
    cls = "TiedSAE" if tied else "UntiedSAE"
    for ld, _ in loaded:
        w = ld.get_learned_dict()
        if (type(ld).__name__ != cls or tuple(w.shape) != (N_FEATS, D)
                or not torch.isfinite(w).all()):
            raise AssertionError(f"learned dict {type(ld).__name__} "
                                 f"{tuple(w.shape)}")
    log(f"  eval.json: fvu {evals[0]['fvu']:.4f} (l1 {l1_values[0]:.1e}) .. "
        f"{evals[-1]['fvu']:.4f} (l1 {l1_values[-1]:.1e}); l0 "
        f"{evals[0]['l0']:.1f} .. {evals[-1]['l0']:.1f}")
    return {"wall_s": wall, "launches": launches, "acts_per_s": acts_per_s,
            "steps": n_steps, "mse": mse, "eval": evals}


def reference_epoch(store: Path, l1_values, main: dict, tied: bool) -> dict:
    """basic_l1_sweep's epoch again — the same member inits, the same
    batch order — on the autodiff path, which launches no kernel. Each
    member's single-batch mse at the main path's logged steps must match
    the main path's, and the steps where mse rose are listed for both."""
    from sparse_coding_tpu_torch.data.chunk_store import device_prefetch
    from sparse_coding_tpu_torch.data.shard_store import open_store
    from sparse_coding_tpu_torch.ensemble import Ensemble
    from sparse_coding_tpu_torch.models.sae import (
        FunctionalSAE,
        FunctionalTiedSAE,
    )
    from sparse_coding_tpu_torch.ops import _build

    sig = FunctionalTiedSAE if tied else FunctionalSAE
    gen = torch.Generator().manual_seed(SEED)
    members = [sig.init(gen, D, N_FEATS, l1_alpha=float(l1))
               for l1 in l1_values]
    ens = Ensemble(members, sig, lr=LR, use_fused=False, device=DEV)
    batches = open_store(store).epoch(BATCH, np.random.default_rng(SEED))
    _build.reset_launches()
    mse, step = {}, 0
    for step, batch in enumerate(device_prefetch(batches, DEV), 1):
        aux = ens.step_batch(batch)
        if step in main["mse"]:
            mse[step] = aux.losses["l_reconstruction"].cpu().tolist()
    if step != main["steps"] or any(_build.LAUNCHES.values()):
        raise AssertionError(f"reference: {step} steps, launches "
                             f"{_build.LAUNCHES}")
    rel = [abs(k - a) / a for s in mse
           for k, a in zip(main["mse"][s], mse[s])]
    steps = sorted(mse)
    rose = {name: [i for i in range(len(l1_values))
                   if m[steps[-1]][i] > m[steps[0]][i]]
            for name, m in (("kernel", main["mse"]), ("autodiff", mse))}
    log(f"  autodiff over the same {step} steps: mse rel diff to the main "
        f"path max {max(rel):.2e}; members whose mse rose from step "
        f"{steps[0]} to {steps[-1]}: kernel path {rose['kernel']}, "
        f"autodiff {rose['autodiff']}")
    if not max(rel) <= RTOL_REFERENCE_MSE:
        raise AssertionError(f"main path's mse is {max(rel):.2e} from the "
                             f"autodiff reference's (> "
                             f"{RTOL_REFERENCE_MSE})")
    return {"mse": mse, "mse_max_rel_diff": max(rel), "rose": rose}


# --- phase 6: every kernel path vs autodiff -----------------------------------

# launches per step of each (family, path): (fwd, bwd, adam_vjp) of the
# family's kernels — the masked family rides the tied ones
PATH_LAUNCHES = {
    "two_stage": (1, 1, 0), "train_step": (1, 1, 1),
    "two_stage_tiled": (1, 1, 0), "train_step_tiled": (1, 1, 1),
}


def family_members(family: str, l1_values):
    """A fresh init of the family's bucket (the same numbers every call):
    the main path's shape, or for the masked family the dictionary-ratio
    shape."""
    from sparse_coding_tpu_torch.models.sae import (
        FunctionalMaskedTiedSAE,
        FunctionalSAE,
        FunctionalTiedSAE,
    )

    g = torch.Generator().manual_seed(1)
    if family == "masked_tied":
        sizes = [int(D * r) for r in MASKED_RATIOS]
        return FunctionalMaskedTiedSAE, [
            FunctionalMaskedTiedSAE.init(g, D, n, max(sizes),
                                         l1_alpha=MASKED_L1)
            for n in sizes]
    sig = FunctionalTiedSAE if family == "tied" else FunctionalSAE
    return sig, [sig.init(g, D, N_FEATS, l1_alpha=float(l1))
                 for l1 in l1_values]


def other_paths(batches: list, l1_values) -> dict:
    from sparse_coding_tpu_torch.ensemble import Ensemble
    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.ops.roofline import FAMILY_PATHS

    out = {}
    for family in ("tied", "untied", "masked_tied"):
        sig, members = family_members(family, l1_values)
        ref = Ensemble(members, sig, lr=LR, use_fused=False, device=DEV)
        ref_losses = [ref.step_batch(b).losses["loss"] for b in batches]
        kernels = UNTIED_KERNELS if family == "untied" else TIED_KERNELS
        weights = ("encoder", "decoder") if family == "untied" \
            else ("encoder",)
        for path in FAMILY_PATHS[family]:
            sig, members = family_members(family, l1_values)
            ens = Ensemble(members, sig, lr=LR, fused_path=path, device=DEV)
            _build.reset_launches()
            losses = [ens.step_batch(b).losses["loss"] for b in batches]
            sync()
            launches = dict(_build.LAUNCHES)
            want = {k: 0 for k in _build.LAUNCHES}
            want.update({k: n * len(batches)
                         for k, n in zip(kernels, PATH_LAUNCHES[path])})
            n_m, n_f = ens.state.params["encoder"].shape[:2]
            want.update(part_launches(
                family != "untied", PATH_LAUNCHES[path][1] * len(batches),
                (n_m, BATCH, n_f)))
            label = f"{family} {path}"
            if launches != want or ens.fused_path != path:
                raise AssertionError(f"{label}: launches {launches}, "
                                     f"expected {want} (resolved "
                                     f"{ens.fused_path})")
            errs = [compare(f"{label}: step {i} loss", got, want_l,
                            RTOL_PATH_LOSS)
                    for i, (got, want_l) in enumerate(zip(losses,
                                                          ref_losses))]
            rel_fro = {}
            for w in weights:
                p, pr = ens.state.params[w], ref.state.params[w]
                rel_fro[w] = float(torch.linalg.vector_norm(p - pr)
                                   / torch.linalg.vector_norm(pr))
                if not rel_fro[w] <= REL_FRO_PATH:
                    raise AssertionError(f"{label}: {w} drifted from "
                                         f"autodiff, relative Frobenius "
                                         f"{rel_fro[w]:.2e}")
            worst = max(e["max_rel_err"] for e in errs)
            out[label] = {"launches": launches, "loss_max_rel_err": worst,
                          "rel_fro": rel_fro}
            log(f"  {label}: launches {launches}; vs autodiff: loss rel err "
                f"{worst:.2e}, relative Frobenius "
                + ", ".join(f"{w} {v:.2e}" for w, v in rel_fro.items()))
        del ref, ens
        torch.cuda.empty_cache()
    return out


# --- the giant single SAE: kernels (phase 2) and main path (phase 7) ----------

def write_big_store(folder: Path, seed: int):
    """The big SAE's synthetic store (d=1024, bfloat16 on disk, 4 chunks of
    131,072 rows), written by the port's ChunkWriter. Returns the generator
    and its torch.Generator, which go on to draw held-out rows."""
    from sparse_coding_tpu_torch.data.chunk_store import ChunkWriter
    from sparse_coding_tpu_torch.data.synthetic import RandomDatasetGenerator

    g = torch.Generator(DEV).manual_seed(seed)
    gen = RandomDatasetGenerator.create(g, BIG_D, BIG_GT, 32, 0.999)
    w = ChunkWriter(folder, BIG_D,
                    chunk_size_gb=BIG_CHUNK_ROWS * BIG_D * 2 / 2**30,
                    dtype="bfloat16")
    if w.rows_per_chunk != BIG_CHUNK_ROWS:
        raise AssertionError(f"rows per chunk {w.rows_per_chunk}")
    n_rows = BIG_CHUNKS * BIG_CHUNK_ROWS
    for lo in range(0, n_rows, 8192):
        w.add(gen.batch(g, min(8192, n_rows - lo)))
    if w.finalize() != BIG_CHUNKS:
        raise AssertionError("big store: wrong chunk count")
    return gen, g


def big_params(gen: torch.Generator, n: int, d: int) -> dict:
    """Big-SAE params on the card as init_big_sae draws them (a unit
    dictionary, an N(0, 1) encoder), with small thresholds and a centre so
    that every term of the kernels' math is non-zero."""
    from sparse_coding_tpu_torch.train.big_sae import init_big_sae

    p = init_big_sae(gen, d, n, BIG_L1, device=DEV)[0].params
    p["threshold"] = (torch.randn((n,), generator=gen) * 0.1).to(DEV)
    p["centering"] = (torch.randn((d,), generator=gen) * 0.05).to(DEV)
    return p


def check_big_kernels(p: dict, x: torch.Tensor, tag: str,
                      total_batch=None) -> dict:
    """big_sae_fwd and big_sae_bwd against their plain versions; the
    backward with the untied residual x̂ − x and the tied one x̂ + ctr − x
    (``total_batch``: its data-sharded form, x a shard of that batch)."""
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    xc = (x - p["centering"]).contiguous()
    alpha = torch.tensor(BIG_L1, device=DEV)
    xhat_ref = fb.big_sae_forward_plain(p, xc)
    out = {"big_sae_fwd": {"xhat": compare(
        f"{tag}:big_sae_fwd.xhat", fb.big_sae_forward(p, xc), xhat_ref,
        RTOL_EXACT)}}
    errs = {}
    for kind, r in (("untied", xhat_ref - x),
                    ("tied", xhat_ref + p["centering"] - x)):
        r = r.contiguous()
        got = fb.big_sae_backward(p, alpha, xc, r, total_batch=total_batch)
        ref = fb.big_sae_backward_plain(p, alpha, xc, r,
                                        total_batch=total_batch)
        for i, field in enumerate(("de", "dwn", "dt", "dctr", "c_totals")):
            errs[f"{field}_{kind}"] = compare(
                f"{tag}:big_sae_bwd.{field} ({kind} r)", got[i], ref[i],
                RTOL_GRAD)
        errs[f"l1_{kind}"] = compare(f"{tag}:big_sae_bwd.l1 ({kind} r)",
                                     got[5][0], ref[5][0], RTOL_EXACT)
        flips = FLIPS_PER_CODE * x.shape[0] * p["dict"].shape[0]
        errs[f"l0_{kind}"] = compare(f"{tag}:big_sae_bwd.l0 ({kind} r)",
                                     got[5][1], ref[5][1], 0.0,
                                     max(1.0, flips))
        del got, ref
    out["big_sae_bwd"] = errs
    sync()
    for name, e in out.items():
        worst = max(v["max_rel_err"] for k, v in e.items()
                    if not is_mask_count(k))
        log(f"  {tag} {name}: ok, worst rel err {worst:.2e}")
    return out


def big_bounds(b: int, n: int, d: int, nnz: int) -> dict:
    """Least time for each big-SAE kernel's work: the encode product is
    dense, the products over the codes count this data's ``nnz`` active
    (row, feature) codes; each input is read once, each output written
    once."""
    f4 = 4
    enc, act = 2.0 * b * n * d, 2.0 * nnz * d
    work = {
        "big_sae_fwd": (enc + act + 2.0 * b * n,
                        f4 * (2 * b * d + 2 * n * d + n)),
        # pre (dense), then r·Wnᵀ, xcᵀ·dpre and cᵀ·r over the active codes
        "big_sae_bwd": (enc + 3 * act + 6.0 * b * n,
                        f4 * (2 * b * d + 4 * n * d + 3 * n + d + 3)),
    }
    out = {}
    for name, (ops, nbytes) in work.items():
        t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
        out[name] = {"bound_ms": 1e3 * max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes", "flops": ops, "bytes": nbytes}
    return out


def time_big_kernels(p: dict, x: torch.Tensor) -> dict:
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    xc = (x - p["centering"]).contiguous()
    r = (fb.big_sae_forward_plain(p, xc) - x).contiguous()
    alpha = torch.tensor(BIG_L1, device=DEV)
    pairs = {
        "big_sae_fwd": (lambda: fb.big_sae_forward(p, xc),
                        lambda: fb.big_sae_forward_plain(p, xc)),
        "big_sae_bwd": (lambda: fb.big_sae_backward(p, alpha, xc, r),
                        lambda: fb.big_sae_backward_plain(p, alpha, xc, r)),
    }
    out = {}
    for name, (kern, plain) in pairs.items():
        # short windows (a backward is about a second): plain, kernel,
        # kernel, plain
        p1 = time_ms(plain, 3)
        k1 = time_ms(kern, 3)
        k2 = time_ms(kern, 3)
        p2 = time_ms(plain, 3)
        out[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                     "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2],
                     "library_ms": None}
        log(f"  {name}: kernel {min(k1, k2):.2f} ms, plain "
            f"{min(p1, p2):.2f} ms")
        torch.cuda.empty_cache()
    return out


def big_launches(steps: int, batch: int = BIG_BATCH,
                 calls: tuple = (1, 1)) -> dict:
    """Every launch count after ``steps`` big-SAE kernel steps of ``calls``
    big_sae_fwd and big_sae_bwd calls each at (batch, BIG_N): each K8 and
    K9 launch once per batch chunk of its kernel (dctr once a call),
    nothing else."""
    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    fwd, bwd = (steps * c for c in calls)
    n_fwd = len(fb.fwd_chunks(batch, BIG_N))
    n_bwd = len(fb.bwd_chunks(batch, BIG_N))
    want = {k: 0 for k in _build.LAUNCHES}
    want.update({"big_sae_fwd": fwd, "big_sae_bwd": bwd})
    want.update({k: fwd * n_fwd for k in _build.BIG_FWD_PARTS})
    want.update({k: bwd if k == "big_sae_bwd_dctr" else bwd * n_bwd
                 for k in _build.BWD_PARTS})
    return want


def peak_bytes(fn) -> int:
    """Device memory ``fn`` allocates at its peak above what was
    allocated before it (max_memory_allocated after a reset)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    torch.cuda.empty_cache()
    return peak


def big_extras(p: dict, x: torch.Tensor, kernel: str) -> dict:
    """big_sae_fwd or big_sae_bwd at the main shape: two calls give the
    same bits; the peak memory of one call beside the plain version's (the
    kernel's must stay within its outputs, Wn and the workspace cap); and
    each of its launches timed alone on the first chunk (CUDA events, 5
    launches; fused_big_sae.one_chunk_launches)."""
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    xc = (x - p["centering"]).contiguous()
    b, d = xc.shape
    n = p["dict"].shape[0]
    if kernel == "big_sae_fwd":
        r = alpha = None
        rows, chunks = fb.fwd_chunk_rows(b, n), fb.fwd_chunks(b, n)
        ws = rows * n
        out = repeat_and_memory(
            kernel, lambda: fb.big_sae_forward(p, xc),
            lambda: fb.big_sae_forward_plain(p, xc),
            4 * (b * d + n * d + ws),
            f"output, Wn, workspace {ws * 4 / 2**20:.0f} MiB")
    else:
        r = (fb.big_sae_forward_plain(p, xc) - x).contiguous()
        alpha = torch.tensor(BIG_L1, device=DEV)
        rows, chunks = fb.bwd_chunk_rows(b, n), fb.bwd_chunks(b, n)
        ws = 2 * rows * n
        out = repeat_and_memory(
            kernel, lambda: fb.big_sae_backward(p, alpha, xc, r),
            lambda: fb.big_sae_backward_plain(p, alpha, xc, r),
            4 * (ws + 3 * n * d + 3 * n + d + 2),
            f"outputs, Wn, workspace {ws * 4 / 2**20:.0f} MiB")
    times = time_parts(fb.one_chunk_launches(kernel, p, xc, r, alpha),
                       f" ({rows} rows)")
    per_call = len(chunks) * sum(v["ms"] for k, v in times.items()
                                 if k != "big_sae_bwd_dctr") \
        + times.get("big_sae_bwd_dctr", {"ms": 0.0})["ms"]
    log(f"  {len(chunks)} chunks: {kernel}'s launches sum to "
        f"{per_call:.2f} ms a call")
    del xc, r
    torch.cuda.empty_cache()
    return {**out, "chunk_rows": rows, "chunks": len(chunks), "parts": times,
            "parts_sum_ms": per_call}


def big_phase2(store: Path, g: torch.Generator) -> dict:
    """Phase 2's big-SAE part: small odd shapes, the main shape (the
    store's first batch) and a batch of several K8 and K9 chunks —
    checks, the last with its launch counts; then at the main shape K8's
    and K9's repeat, memory and per-launch times, the active codes,
    bounds and times."""
    from sparse_coding_tpu_torch.data.chunk_store import ChunkStore
    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    checks = {}
    for b, n, d in BIG_SMALL_SHAPES:
        x = torch.randn((b, d), generator=g).to(DEV)
        checks[f"big {b}x{n}x{d}"] = check_big_kernels(big_params(g, n, d),
                                                       x, f"big d={d}")
    x = torch.as_tensor(ChunkStore(store).load_chunk(0)[:BIG_BATCH]).to(DEV)
    p = big_params(g, BIG_N, BIG_D)
    checks["main"] = check_big_kernels(p, x, "big main")
    torch.cuda.empty_cache()
    b, n, d = BIG_CHUNK_SHAPE
    _build.reset_launches()
    checks[f"big {b}x{n}x{d}"] = check_big_kernels(
        big_params(g, n, d), torch.randn((b, d), generator=g).to(DEV),
        "big chunks")
    want = big_launches(1, b, (1, 2))
    if dict(_build.LAUNCHES) != want:
        raise AssertionError(f"big chunks: launches {dict(_build.LAUNCHES)}, "
                             f"expected {want}")
    log(f"  big chunks: {len(fb.fwd_chunks(b, n))} big_sae_fwd chunks, "
        f"{len(fb.bwd_chunks(b, n))} big_sae_bwd chunks")
    torch.cuda.empty_cache()
    extras = {k: big_extras(p, x, k) for k in BIG_KERNELS}
    xc = x - p["centering"]
    nnz = int(((xc @ p["encoder"] + p["threshold"]) > 0).sum())
    del xc
    torch.cuda.empty_cache()
    log(f"  big main shape: {nnz} of {BIG_BATCH * BIG_N} codes active "
        f"({100 * nnz / (BIG_BATCH * BIG_N):.1f}%)")
    timing = time_big_kernels(p, x)
    return {"checks": checks, "active_codes": nnz, "timing": timing,
            "bounds": big_bounds(BIG_BATCH, BIG_N, BIG_D, nnz),
            "extras": extras}


def _big_snapshot(state) -> dict:
    return {"step": int(state.step), "c_totals": state.c_totals.cpu(),
            "worst_losses": state.worst_losses.cpu(),
            "n_dead": int((state.c_totals == 0).sum())}


def timed_big_steps(real_make, events: list, metrics: list, **step_kwargs):
    """A ``make_big_sae_step`` whose steps record a CUDA event after each
    step into ``events`` and keep its metrics in ``metrics`` (on the card:
    it adds no synchronization), built with ``step_kwargs`` besides the
    caller's."""
    def make(*args, **kwargs):
        step = real_make(*args, **kwargs, **step_kwargs)

        def timed(state, batch):
            state, m = step(state, batch)
            done = torch.cuda.Event(enable_timing=True)
            done.record()
            events.append(done)
            metrics.append(m)
            return state, m
        return timed
    return make


def big_main_path(store: Path, out_dir: Path) -> dict:
    """train_big_sae through its entry point on the card. Its step function
    is wrapped to record a CUDA event after each step and keep the step's
    metrics (on the card: the wrapper adds no synchronization), so
    activations/s over steps 2–16 is the device-timeline time from the
    end of step 1 to the end of step 16, which includes any wait for data;
    resurrection is wrapped to keep the c_totals and worst losses it
    consumed. Neither wrapper changes what runs."""
    from sparse_coding_tpu_torch.config import BigSAEArgs
    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.train import big_sae as bs

    events, metrics, snaps = [], [], []
    real_make, real_resurrect = bs.make_big_sae_step, bs.resurrect_dead_features
    make = timed_big_steps(real_make, events, metrics)

    def resurrect(state, *mesh):
        snaps.append(_big_snapshot(state))
        return real_resurrect(state, *mesh)

    cfg = BigSAEArgs(activation_dim=BIG_D, n_feats=BIG_N,
                     batch_size=BIG_BATCH, l1_alpha=BIG_L1, lr=BIG_LR,
                     dataset_folder=str(store), output_folder=str(out_dir),
                     n_epochs=BIG_EPOCHS, resurrect_every=BIG_RESURRECT,
                     seed=SEED)
    bs.make_big_sae_step, bs.resurrect_dead_features = make, resurrect
    try:
        _build.reset_launches()
        sync()
        t0 = time.perf_counter()
        state = bs.train_big_sae(cfg, device=DEV)
        sync()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    finally:
        bs.make_big_sae_step, bs.resurrect_dead_features = (real_make,
                                                            real_resurrect)
    want = big_launches(BIG_STEPS)
    if launches != want or len(events) != BIG_STEPS:
        raise AssertionError(f"big-SAE main path: {len(events)} steps, "
                             f"launches {launches}, expected {want}")
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    if [s["step"] for s in snaps] != list(range(BIG_RESURRECT, BIG_STEPS + 1,
                                                BIG_RESURRECT)):
        raise AssertionError(f"resurrections at {[s['step'] for s in snaps]}")
    bad = [i for i, m in enumerate(metrics)
           if not all(math.isfinite(v) for v in m.values())]
    if bad:
        raise AssertionError(f"non-finite metrics at steps {bad}")
    window_s = events[0].elapsed_time(events[-1]) / 1e3
    acts_per_s = (BIG_STEPS - 1) * BIG_BATCH / window_s
    log(f"  train_big_sae: {wall:.2f} s wall, launches {launches}; "
        f"{acts_per_s:.0f} acts/s over steps 2-{BIG_STEPS} (data loading "
        f"included, {1e3 * BIG_BATCH / acts_per_s:.1f} ms a step); loss "
        f"{metrics[0]['loss']:.4g} -> {metrics[-1]['loss']:.4g}, l0 "
        f"{metrics[0]['l0']:.1f} -> {metrics[-1]['l0']:.1f}; n_dead at "
        f"resurrection {[s['n_dead'] for s in snaps]}")
    return {"state": state, "wall_s": wall, "launches": launches,
            "acts_per_s": acts_per_s, "metrics": metrics, "snaps": snaps,
            "step_ms": 1e3 * BIG_BATCH / acts_per_s}


def rel_fro(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def big_reference(store: Path, main: dict) -> dict:
    """The main path's 16 steps again — same seed, init, store, rng and
    batch order, resurrection at the same steps — on the autodiff step,
    which launches no kernel. Final params, and c_totals and the worst
    losses just before each resurrection, must match the main path's. Its
    steps are timed as the main path's are: a CUDA event after each step
    (no added synchronization; the losses are read after the last step),
    activations/s over steps 2–16 on the device timeline."""
    from sparse_coding_tpu_torch.data.chunk_store import device_prefetch
    from sparse_coding_tpu_torch.data.shard_store import open_store
    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.train import big_sae as bs

    state, opt, l1 = bs.init_big_sae(torch.Generator().manual_seed(SEED),
                                     BIG_D, BIG_N, BIG_L1, lr=BIG_LR,
                                     device=DEV)
    step = bs.make_big_sae_step(opt, l1, use_fused=False)
    store_ = open_store(store, quarantine_corrupt=True)
    rng = np.random.default_rng(SEED)
    _build.reset_launches()
    n, snaps, losses, events = 0, [], [], []
    for _ in range(BIG_EPOCHS):
        for batch in device_prefetch(store_.epoch(BIG_BATCH, rng), DEV):
            state, m = step(state, batch)
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            losses.append(m["loss"])
            n += 1
            if n % BIG_RESURRECT == 0:
                snaps.append(_big_snapshot(state))
                state, _ = bs.resurrect_dead_features(state)
    sync()
    losses = [float(v) for v in losses]
    if n != BIG_STEPS or any(_build.LAUNCHES.values()):
        raise AssertionError(f"big reference: {n} steps, launches "
                             f"{_build.LAUNCHES}")
    step_ms = events[0].elapsed_time(events[-1]) / (n - 1)
    log(f"  autodiff replay: {1e3 * BIG_BATCH / step_ms:.0f} acts/s over "
        f"steps 2-{n} ({step_ms:.1f} ms a step; kernel path "
        f"{main['step_ms']:.1f})")
    fro = {k: rel_fro(main["state"].params[k], state.params[k])
           for k in bs.PARAM_NAMES}
    for k, v in fro.items():
        if not v <= REL_FRO_BIG_REPLAY:
            raise AssertionError(f"big main path: {k} is {v:.2e} (relative "
                                 "Frobenius) from its autodiff replay")
    errs = {}
    for got, want in zip(main["snaps"], snaps):
        s = want["step"]
        if got["n_dead"] != want["n_dead"]:
            raise AssertionError(f"step {s}: n_dead {got['n_dead']} vs "
                                 f"{want['n_dead']} on autodiff")
        errs[f"c_totals@{s}"] = compare(f"big replay c_totals@{s}",
                                        got["c_totals"], want["c_totals"],
                                        RTOL_BIG_CTOTALS)
        errs[f"worst_losses@{s}"] = compare(
            f"big replay worst_losses@{s}", got["worst_losses"],
            want["worst_losses"], RTOL_BIG_WORST)
    loss_rel = max(abs(a["loss"] - b) / abs(b)
                   for a, b in zip(main["metrics"], losses))
    log(f"  autodiff replay of {n} steps: relative Frobenius "
        + ", ".join(f"{k} {v:.2e}" for k, v in fro.items())
        + "; c_totals/worst losses before resurrection "
        + ", ".join(f"{k} {v['max_rel_err']:.2e}" for k, v in errs.items())
        + f"; per-step loss max rel diff {loss_rel:.2e} (logged, not "
        "bounded)")
    del state
    torch.cuda.empty_cache()
    return {"rel_fro": fro, "buffers": errs, "loss_max_rel_diff": loss_rel,
            "step_ms": step_ms, "acts_per_s": 1e3 * BIG_BATCH / step_ms}


def big_side_by_side(batches: list, tag: str) -> dict:
    """From one fresh init, the kernel step and the autodiff step on
    ``batches`` (rows of the big SAE's width on the card): per-step
    metrics within RTOL_BIG_STEP, each param's ‖Δ‖/‖·‖ within
    REL_FRO_BIG_REPLAY."""
    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.train import big_sae as bs

    d = batches[0].shape[1]
    out, states = {}, {}
    for fused in (True, False):
        state, opt, l1 = bs.init_big_sae(torch.Generator().manual_seed(1),
                                         d, BIG_N, BIG_L1, lr=BIG_LR,
                                         device=DEV)
        step = bs.make_big_sae_step(opt, l1, use_fused=fused)
        _build.reset_launches()
        ms = []
        for b in batches:
            state, m = step(state, b)
            ms.append(m)
        sync()
        n_k = len(batches) if fused else 0
        if (_build.LAUNCHES["big_sae_fwd"], _build.LAUNCHES["big_sae_bwd"]) \
                != (n_k, n_k):
            raise AssertionError(f"{tag} side by side (use_fused={fused}): "
                                 f"launches {_build.LAUNCHES}")
        out[fused], states[fused] = ms, state
    errs = {f"step {i} {k}": compare(f"{tag} side by side step {i} {k}",
                                     out[True][i][k], out[False][i][k],
                                     RTOL_BIG_STEP)
            for i in range(len(batches)) for k in out[True][i]}
    fro = {k: rel_fro(states[True].params[k], states[False].params[k])
           for k in bs.PARAM_NAMES}
    if not all(v <= REL_FRO_BIG_REPLAY for v in fro.values()):
        raise AssertionError(f"{tag} side by side: params ‖Δ‖/‖·‖ {fro} > "
                             f"{REL_FRO_BIG_REPLAY}")
    worst = max(e["max_rel_err"] for e in errs.values())
    log(f"  {tag} {len(batches)} steps, kernels vs autodiff from one init "
        f"at d={d}: metrics max rel err {worst:.2e}; params ‖Δ‖/‖·‖ "
        + ", ".join(f"{k} {v:.2e}" for k, v in fro.items()))
    del states, out
    torch.cuda.empty_cache()
    return {"metrics_max_rel_err": worst, "rel_fro": fro}


def big_resurrection(state, batch: torch.Tensor) -> dict:
    """Mark BIG_N_DEAD features dead on the trained state (after one more
    kernel step refills the worst-example buffer): resurrection on the card
    must revive exactly those and match the same call on a CPU copy."""
    from sparse_coding_tpu_torch.train import big_sae as bs

    step = bs.make_big_sae_step(bs.BigSAEAdam(BIG_LR),
                                torch.tensor(BIG_L1, device=DEV))
    state, _ = step(state, batch)
    dead = torch.zeros(BIG_N, dtype=torch.bool)
    dead[torch.randperm(BIG_N, generator=torch.Generator().manual_seed(2))
         [:BIG_N_DEAD]] = True
    state = state.replace(c_totals=torch.where(
        dead.to(DEV), 0.0, state.c_totals + 1.0))
    cpu = state.replace(**{
        f: {k: v.cpu() for k, v in getattr(state, f).items()}
        for f in ("params", "mu", "nu")}, **{
        f: getattr(state, f).cpu() for f in (
            "count", "c_totals", "worst_losses", "worst_vectors", "step")})
    got, n_dead = bs.resurrect_dead_features(state)
    want, n_dead_cpu = bs.resurrect_dead_features(cpu)
    sync()
    enc_old, enc = state.params["encoder"].cpu(), got.params["encoder"].cpu()
    changed = (enc != enc_old).any(dim=0)
    if int(n_dead) != BIG_N_DEAD or int(n_dead_cpu) != BIG_N_DEAD \
            or not torch.equal(changed, dead):
        raise AssertionError(f"resurrection: n_dead {int(n_dead)} (CPU "
                             f"{int(n_dead_cpu)}), revived "
                             f"{int(changed.sum())} columns, "
                             f"{int((changed & dead).sum())} of them marked")
    errs = {"encoder": compare("resurrection encoder vs CPU", enc,
                               want.params["encoder"], RTOL_EXACT)}
    for k in bs.PARAM_NAMES:
        for f in ("mu", "nu"):
            errs[f"{f}_{k}"] = compare(f"resurrection {f}[{k}] vs CPU",
                                       getattr(got, f)[k].cpu(),
                                       getattr(want, f)[k], 0.0)
    dead_dev = dead.to(DEV)
    if (float(got.mu["encoder"][:, dead_dev].abs().max()) != 0.0
            or float(got.nu["dict"][dead_dev].abs().max()) != 0.0
            or float(got.c_totals.abs().max()) != 0.0):
        raise AssertionError("resurrection left moments or c_totals")
    log(f"  resurrection on the card: revived exactly the {BIG_N_DEAD} "
        f"marked features; encoder vs CPU max rel err "
        f"{errs['encoder']['max_rel_err']:.2e}; moments equal")
    return {"n_dead": int(n_dead), "encoder_max_rel_err":
            errs["encoder"]["max_rel_err"]}


def big_export(state, held_out: torch.Tensor) -> dict:
    """The exported BigSAEDict on held-out rows: a finite FVU that equals
    the training objective's mse over the rows' variance (the kernels'
    loss on the same rows), beside the FVU of the fresh init."""
    from sparse_coding_tpu_torch.metrics.core import (
        fraction_variance_unexplained,
    )
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb
    from sparse_coding_tpu_torch.train import big_sae as bs

    ld = bs.to_learned_dict(state)
    fvu = float(fraction_variance_unexplained(ld, held_out))
    _, aux, _ = fb.fused_big_sae_loss_and_grads(state.params, held_out,
                                                BIG_L1, state.tied)
    var = float(torch.mean(torch.square(held_out - held_out.mean(dim=0))))
    objective = float(aux["mse"]) / var
    init = bs.init_big_sae(torch.Generator().manual_seed(SEED), BIG_D, BIG_N,
                           BIG_L1, device=DEV)[0]
    fvu_init = float(fraction_variance_unexplained(bs.to_learned_dict(init),
                                                   held_out))
    log(f"  export on {held_out.shape[0]} held-out rows: FVU {fvu:.6g} "
        f"(the objective's {objective:.6g}); the init's FVU {fvu_init:.6g}")
    if not (math.isfinite(fvu) and abs(fvu - objective) <= RTOL_EXACT * 10
            * abs(objective)):
        raise AssertionError(f"export FVU {fvu} vs the objective's "
                             f"{objective}")
    return {"fvu": fvu, "fvu_objective": objective, "fvu_init": fvu_init}


def big_main_phase(store: Path, tmp: Path, held_out: torch.Tensor) -> dict:
    from sparse_coding_tpu_torch.data.chunk_store import ChunkStore

    main = big_main_path(store, tmp / "big_out")
    out = {k: v for k, v in main.items() if k not in ("state", "snaps")}
    out["reference"] = big_reference(store, main)
    cs = ChunkStore(store)
    rows = [cs.load_chunk(0)[:BIG_BATCH], cs.load_chunk(0)[BIG_BATCH:],
            cs.load_chunk(1)[:BIG_BATCH]]
    out["side_by_side"] = big_side_by_side(
        [torch.as_tensor(r).to(DEV) for r in rows], "")
    state = main.pop("state")
    out["export"] = big_export(state, held_out)
    batch = torch.as_tensor(cs.load_chunk(2)[:BIG_BATCH]).to(DEV)
    out["resurrection"] = big_resurrection(state, batch)
    del state, batch
    torch.cuda.empty_cache()
    return out


# --- phase 8: the full sweep (train/sweep.py) ------------------------------

# the sweep's CLI on the canonical width (Pythia-70M, d=512, ratio 4,
# batch 2048): tied_vs_not over DEFAULT_L1_RANGE (16 members each), a
# 4-chunk store = 64 steps (6 chunks until phase 19 took the run past its
# time), a checkpoint set every chunk; depth is the only cut
SWEEP_CHUNKS, SWEEP_MEMBERS = 4, 16
SWEEP_STEPS = SWEEP_CHUNKS * ROWS_PER_CHUNK // BATCH
SWEEP_DICT_RATIO_CHUNKS = 2


def sweep_args(store: Path, out: Path, *extra: str) -> list[str]:
    return ["--experiment", "tied_vs_not", "--dataset_folder", str(store),
            "--output_folder", str(out), "--batch_size", str(BATCH),
            "--learned_dict_ratio", str(RATIO), "--lr", str(LR),
            "--seed", str(SEED), "--n_chunks", str(SWEEP_CHUNKS),
            "--checkpoint_every_chunks", "1", "--image_metrics_every", "none",
            "--log_every", str(ROWS_PER_CHUNK // BATCH), *extra]


def sweep_in_process(args: list[str], obs_dir: Path, fault=None) -> float:
    """``train.sweep.main(args)`` in this process, its events to
    ``obs_dir``, with an optional fault plan; returns the wall seconds."""
    import contextlib
    import io

    from sparse_coding_tpu_torch import obs
    from sparse_coding_tpu_torch.resilience import faults
    from sparse_coding_tpu_torch.train import sweep as tsweep

    sink = obs.EventSink(obs_dir / "events.jsonl")
    prev_sink, prev_reg = obs.configure_sink(sink), obs.set_registry(
        obs.Registry())
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), faults.inject(*(fault or ())):
            tsweep.main(args)
        sync()
    finally:
        obs.set_registry(prev_reg)
        obs.configure_sink(prev_sink)
        sink.close()
    return time.perf_counter() - t0


def sweep_subprocess(args: list[str], obs_dir: Path, crash_plan: str = "",
                     sigterm_when: Path = None,
                     fault_plan: str = "") -> subprocess.CompletedProcess:
    """``python -m sparse_coding_tpu_torch.train.sweep`` in a child, with
    an optional crash or fault plan; ``sigterm_when``: SIGTERM the child
    once that file exists."""
    import os
    import signal

    env = dict(os.environ, SPARSE_CODING_OBS_DIR=str(obs_dir))
    env.pop("SPARSE_CODING_FAULT_PLAN", None)
    env.pop("SPARSE_CODING_CRASH_PLAN", None)
    if crash_plan:
        env["SPARSE_CODING_CRASH_PLAN"] = crash_plan
    if fault_plan:
        env["SPARSE_CODING_FAULT_PLAN"] = fault_plan
    proc = subprocess.Popen(
        [sys.executable, "-m", "sparse_coding_tpu_torch.train.sweep", *args],
        cwd=Path(__file__).resolve().parent, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        if sigterm_when is not None:
            while proc.poll() is None and not sigterm_when.exists():
                time.sleep(0.05)
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return subprocess.CompletedProcess(proc.args, proc.returncode, stdout,
                                       stderr)


def logged_steps(out: Path) -> dict[int, dict]:
    """metrics.jsonl's records merged by step (the sweep logs one record
    per entry at each log step)."""
    merged: dict[int, dict] = {}
    for rec in read_metrics(out / "metrics.jsonl"):
        merged.setdefault(rec["step"], {}).update(rec)
    return merged


def read_events(obs_dir: Path) -> list[dict]:
    from sparse_coding_tpu_torch.obs import read_events as read

    return [e for path in sorted(obs_dir.glob("*.jsonl")) for e in read(path)]


def final_dicts(out: Path, name: str, ci: int = SWEEP_CHUNKS - 1) -> list:
    from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts

    return load_learned_dicts(out / f"_{ci}" / f"{name}_learned_dicts.pkl")


def dicts_equal(a: list, b: list, skip=()) -> list[int]:
    """Indices of the members whose exported tensors differ (bitwise)."""
    bad = []
    for i, ((la, _), (lb, _)) in enumerate(zip(a, b)):
        if i in skip:
            continue
        for f in ("encoder", "encoder_bias", "dictionary"):
            if hasattr(la, f) and not torch.equal(getattr(la, f),
                                                  getattr(lb, f)):
                bad.append(i)
                break
    return bad


def assert_bitwise_run(out: Path, ref: Path, what: str) -> None:
    """Final learned dicts, evals and checkpoint set bitwise equal."""
    for name in ("tied", "untied"):
        bad = dicts_equal(final_dicts(out, name), final_dicts(ref, name))
        if bad:
            raise AssertionError(f"{what}: {name} members {bad} differ from "
                                 "the uninterrupted run's")
        f = Path(f"_{SWEEP_CHUNKS - 1}") / f"{name}_eval.json"
        if (out / f).read_bytes() != (ref / f).read_bytes():
            raise AssertionError(f"{what}: {f} differs from the "
                                 "uninterrupted run's")
        for suffix in (".tensors", ".tensors.meta.json"):
            f = f"{name}_0{suffix}"
            if (out / "ckpt" / f).read_bytes() != (ref / "ckpt" / f).read_bytes():
                raise AssertionError(f"{what}: ckpt/{f} differs from the "
                                     "uninterrupted run's")


def sweep_numbers(events: list[dict]) -> dict:
    """Activations/s from the sweep.chunk spans (rows over the chunk's
    training wall, through the chunk-boundary sync), checkpoint seconds
    per chunk, and the probe's samples."""
    chunks = [e for e in events if e.get("span") == "sweep.chunk"]
    ckpts = [e for e in events if e.get("span") == "sweep.checkpoint"]
    later = chunks[1:] or chunks
    samples = [e for e in events if e.get("kind") == "perf.sample"]
    metrics = [e for e in events if e.get("kind") == "metrics"]
    gauges = metrics[-1]["registry"]["gauges"] if metrics else {}
    return {
        "chunks": len(chunks),
        "acts_per_s": sum(e["rows"] for e in later)
        / sum(e["train_s"] for e in later),
        "acts_per_s_first_chunk": chunks[0]["rows"] / chunks[0]["train_s"],
        "timer_acts_per_s": [e["acts_per_sec"] for e in chunks],
        "chunk_s": [e["dur_s"] for e in chunks],
        "ckpt_s": [e["dur_s"] for e in ckpts],
        "ckpt_bytes": ckpts[0]["bytes"] if ckpts else 0,
        "probe_samples": [{k: e.get(k) for k in ("device_s", "mfu", "path")}
                          for e in samples],
        "train_mfu": gauges.get("train.mfu", {}).get("value"),
    }


def sweep_launches() -> dict:
    """Every launch count of one tied_vs_not sweep: each kernel of both
    families once per step, their parts per their schedules, K8/K9
    none."""
    from sparse_coding_tpu_torch.ops import _build

    shape = (SWEEP_MEMBERS, BATCH, N_FEATS)
    want = {k: SWEEP_STEPS if k in TIED_KERNELS + UNTIED_KERNELS else 0
            for k in _build.LAUNCHES}
    want.update(part_launches(True, SWEEP_STEPS, shape))
    want.update(part_launches(False, SWEEP_STEPS, shape))
    return want


def sweep_phase(store: Path, tmp: Path) -> dict:
    """Phase 8 — the full sweep through its CLI: (a) the kernels launch
    once per step and the logged losses are finite; (b) SIGKILL at
    sweep.chunk (hit 3), then at ckpt.swap (hit 3), and --resume true end
    bitwise equal to the uninterrupted run; (c) SIGTERM mid-run exits
    cleanly and resumes bitwise; (d) the member=3 drill freezes tied
    member 3 and leaves every other member bitwise; (e) a NaN batch rolls
    back and replays bitwise the run over the store with that chunk
    quarantined; (f) dict_ratio at the masked shape on its kernels; (g)
    the same sweep on autodiff agrees with the kernel run; (h) bfloat16
    training runs on the kernels. (a)'s output stays for phase 9, in
    ``rep["a"]["out"]``."""
    import shutil

    from sparse_coding_tpu_torch.ops import _build

    rep: dict = {}
    steps_per_chunk = ROWS_PER_CHUNK // BATCH

    # (a) the uninterrupted run, launches counted
    out_a = tmp / "sweep_a"
    _build.reset_launches()
    wall = sweep_in_process(sweep_args(store, out_a), tmp / "obs_a")
    launches = dict(_build.LAUNCHES)
    want = sweep_launches()
    if launches != want:
        raise AssertionError(f"(a) launches {launches}, expected {want}")
    logged = logged_steps(out_a)
    if list(logged) != list(range(steps_per_chunk, SWEEP_STEPS + 1,
                                  steps_per_chunk)) or not all(
            f"{n}/loss_mean" in r for r in logged.values()
            for n in ("tied", "untied")):
        raise AssertionError(f"(a) logged steps {list(logged)}")
    bad = [(step, k) for step, r in logged.items() for k, v in r.items()
           if isinstance(v, float) and not math.isfinite(v)]
    if bad:
        raise AssertionError(f"(a) non-finite logged values {bad[:5]}")
    nums = sweep_numbers(read_events(tmp / "obs_a"))
    rep["a"] = {"wall_s": wall, "launches": launches, "out": str(out_a),
                **nums, "host_io": host_io_numbers(read_events(tmp / "obs_a"))}
    log(f"  (a) tied_vs_not, {SWEEP_STEPS} steps in {wall:.1f} s: each "
        f"kernel {SWEEP_STEPS} launches; {nums['acts_per_s']:.0f} acts/s "
        f"(chunks 2-{SWEEP_CHUNKS}, both ensembles, rows over training "
        f"wall); checkpoint set {nums['ckpt_bytes'] / 2**30:.2f} GiB in "
        f"{np.mean(nums['ckpt_s']):.2f} s a chunk (min "
        f"{min(nums['ckpt_s']):.2f}, max {max(nums['ckpt_s']):.2f}); "
        f"train.mfu {nums['train_mfu']} over {len(nums['probe_samples'])} "
        "probe samples")

    # (b) and (c) run in child processes, three chains at once beside the
    # in-process drills (d), (e), (f) and (h): none of them is timed but
    # (b)'s restore, which is read beside them; (g), timed, runs after
    # them alone. An in-process sweep captures this process's stdout, so
    # the chains return their log lines
    def kill_and_resume(site: str) -> tuple[dict, str]:
        """(b) SIGKILL at a crash barrier, then --resume true."""
        out = tmp / f"sweep_b_{site}"
        killed = sweep_subprocess(sweep_args(store, out), tmp / f"obs_b_{site}",
                                  crash_plan=f"{site}:nth=3")
        if killed.returncode != -9 or f"SIGKILL at site {site!r}" not in \
                killed.stderr:
            raise AssertionError(f"(b) {site}: rc {killed.returncode}\n"
                                 f"{killed.stderr[-3000:]}")
        obs_r = tmp / f"obs_b_{site}_resume"
        t0 = time.perf_counter()
        resumed = sweep_subprocess(sweep_args(store, out, "--resume", "true"),
                                   obs_r)
        wall = time.perf_counter() - t0
        if resumed.returncode != 0:
            raise AssertionError(f"(b) {site} resume: rc "
                                 f"{resumed.returncode}\n"
                                 f"{resumed.stderr[-3000:]}")
        assert_bitwise_run(out, out_a, f"(b) {site}")
        ev = read_events(obs_r)
        resume_s = [e["dur_s"] for e in ev if e.get("span") == "sweep.resume"]
        done = [e["chunks_done"] for e in ev if e.get("span") == "sweep.resume"]
        shutil.rmtree(out)
        return ({"resume_s": resume_s[0], "chunks_done": done[0],
                 "resumed_wall_s": wall},
                f"  (b) SIGKILL at {site} hit 3, resumed from chunk "
                f"{done[0]} (restore {resume_s[0]:.2f} s; the resumed "
                f"process {wall:.1f} s wall, beside the other drills): "
                "bitwise equal to (a)")

    def sigterm_and_resume() -> tuple[dict, str]:
        """(c) SIGTERM once the first checkpoint set exists, then resume."""
        out = tmp / "sweep_c"
        pre = sweep_subprocess(
            sweep_args(store, out), tmp / "obs_c",
            sigterm_when=out / "ckpt" / "untied_0.tensors.meta.json")
        m = re.search(r"checkpointed after chunk (\d+)", pre.stdout)
        if pre.returncode != 0 or m is None or not 0 < int(m.group(1)) < \
                SWEEP_CHUNKS:
            raise AssertionError(f"(c) SIGTERM: rc {pre.returncode}, stdout "
                                 f"{pre.stdout[-500:]}\n{pre.stderr[-3000:]}")
        resumed = sweep_subprocess(sweep_args(store, out, "--resume", "true"),
                                   tmp / "obs_c_resume")
        if resumed.returncode != 0:
            raise AssertionError(f"(c) resume: {resumed.stderr[-3000:]}")
        assert_bitwise_run(out, out_a, "(c) SIGTERM")
        shutil.rmtree(out)
        return ({"preempted_after": int(m.group(1))},
                f"  (c) SIGTERM: SweepPreempted after chunk {m.group(1)}, "
                "exit 0; resumed bitwise equal to (a)")

    pool = concurrent.futures.ThreadPoolExecutor(3)
    chains = {site: pool.submit(kill_and_resume, site)
              for site in ("sweep.chunk", "ckpt.swap")}
    chains["c"] = pool.submit(sigterm_and_resume)
    try:
        rep.update(in_process_drills(store, tmp, out_a, steps_per_chunk))
    finally:
        pool.shutdown(wait=True)
    rep["b"] = {}
    for key, chain in chains.items():
        result, line = chain.result()
        log(line)
        if key == "c":
            rep["c"] = result
        else:
            rep["b"][key] = result
    # (g) the same sweep on autodiff
    out = tmp / "sweep_auto"
    _build.reset_launches()
    wall = sweep_in_process(sweep_args(store, out, "--use_fused", "off"),
                            tmp / "obs_auto")
    if any(_build.LAUNCHES.values()):
        raise AssertionError(f"(g) autodiff launched {_build.LAUNCHES}")
    ka, ra = logged_steps(out_a)[SWEEP_STEPS], logged_steps(out)[SWEEP_STEPS]
    keys = [k for k in ka if k.endswith("/loss")]
    rel = max(abs(ka[k] - ra[k]) / abs(ra[k]) for k in keys)
    auto = sweep_numbers(read_events(tmp / "obs_auto"))
    rep["g"] = {"wall_s": wall, "max_rel_loss_diff": rel,
                "acts_per_s": auto["acts_per_s"], "members": len(keys)}
    log(f"  (g) autodiff: final logged loss of each of {len(keys)} members "
        f"within {rel:.2e} of the kernel run's (bound "
        f"{RTOL_REFERENCE_MSE}); {auto['acts_per_s']:.0f} acts/s")
    if not (len(keys) == 2 * SWEEP_MEMBERS and rel <= RTOL_REFERENCE_MSE):
        raise AssertionError(f"(g) autodiff vs kernels: {rel:.2e} over "
                             f"{len(keys)} members")
    shutil.rmtree(out)

    return rep


def in_process_drills(store: Path, tmp: Path, out_a: Path,
                      steps_per_chunk: int) -> dict:
    """Phase 8's drills in this process, beside (b)'s and (c)'s children:
    (d) the member drill, (e) the NaN drill, (f) dict_ratio and (h)
    bfloat16 training."""
    import shutil

    from sparse_coding_tpu_torch.data.ledger import (
        load_quarantine,
        record_quarantine,
    )
    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.resilience.faults import FaultSpec

    rep: dict = {}
    # (d) the member drill: tied member 3's loss scale poisoned at batch 3
    out = tmp / "sweep_d"
    sweep_in_process(sweep_args(store, out), tmp / "obs_d", fault=[FaultSpec(
        site="sweep.anomaly", nth=3, error="RuntimeError",
        message="member=3")])
    ledger = json.loads((out / "guardian.json").read_text())
    tied = final_dicts(out, "tied")
    if (list(ledger["members"]) != ["tied/tied/3"] or ledger["rollbacks"]
            or [i for i, (_, h) in enumerate(tied) if h.get("diverged")]
            != [3]):
        raise AssertionError(f"(d) ledger {ledger}")
    bad = {n: dicts_equal(final_dicts(out, n), final_dicts(out_a, n),
                          skip=(3,) if n == "tied" else ())
           for n in ("tied", "untied")}
    if any(bad.values()):
        raise AssertionError(f"(d) members other than tied 3 moved: {bad}")
    rep["d"] = {"quarantined": list(ledger["members"])}
    log("  (d) member=3 drill: tied member 3 frozen, ledgered and tagged "
        "diverged; the other 31 members bitwise equal to (a)")
    shutil.rmtree(out)

    # (e) a NaN batch in chunk position 1 (batch 24 of 16 a chunk)
    st_e = tmp / "store_e"
    shutil.copytree(store, st_e)
    out = tmp / "sweep_e"
    sweep_in_process(sweep_args(st_e, out), tmp / "obs_e", fault=[FaultSpec(
        site="sweep.anomaly", nth=steps_per_chunk + 8, mode="nan")])
    ledger = json.loads((out / "guardian.json").read_text())
    bad_chunks = list(load_quarantine(st_e))
    if (len(bad_chunks) != 1 or ledger["members"]
            or list(ledger["rollbacks"]) != ["chunk[1]"]):
        raise AssertionError(f"(e) ledger {ledger}, quarantined {bad_chunks}")
    st_g = tmp / "store_g"
    shutil.copytree(store, st_g)
    record_quarantine(st_g, bad_chunks[0], "pre-quarantined",
                      f"{bad_chunks[0]}.npy")
    out_g = tmp / "sweep_g"
    sweep_in_process(sweep_args(st_g, out_g), tmp / "obs_g")
    rollback = [e for e in read_events(tmp / "obs_e")
                if e.get("span") == "guardian.rollback"]
    bad = {n: dicts_equal(final_dicts(out, n), final_dicts(out_g, n))
           for n in ("tied", "untied")}
    if any(bad.values()) or len(rollback) != 1:
        raise AssertionError(f"(e) members {bad} differ from the run over "
                             f"the pre-quarantined store; rollbacks "
                             f"{rollback}")
    rep["e"] = {"chunk": bad_chunks[0], "rollback_s": rollback[0]["dur_s"]}
    log(f"  (e) NaN drill: one rollback ({rollback[0]['dur_s']:.2f} s) to "
        f"the chunk-1 set, chunk {bad_chunks[0]} quarantined; final dicts "
        "bitwise equal to the run over the pre-quarantined store")
    for path in (out, out_g, st_e, st_g):
        shutil.rmtree(path)

    # (f) dict_ratio at the masked shape on its kernels (two_stage_tiled)
    out = tmp / "sweep_f"
    args = sweep_args(store, out, "--n_chunks", str(SWEEP_DICT_RATIO_CHUNKS))
    args[args.index("tied_vs_not")] = "dict_ratio"
    _build.reset_launches()
    wall = sweep_in_process(args, tmp / "obs_f")
    launches = dict(_build.LAUNCHES)
    steps = SWEEP_DICT_RATIO_CHUNKS * steps_per_chunk
    main_counts = {k: launches[k] for k in _build.KERNELS}
    want = {k: steps if k in ("sae_tied_fwd", "sae_tied_bwd") else 0
            for k in _build.KERNELS}
    parts = {k: launches[k] for k in _build.TIED_FWD_PARTS
             + _build.TIED_BWD_PARTS}
    if main_counts != want or not all(parts.values()):
        raise AssertionError(f"(f) launches {launches}")
    recs = [r for r in read_metrics(out / "metrics.jsonl")
            if "dict_ratio/loss_mean" in r]
    if not recs or not all(math.isfinite(v) for r in recs for v in r.values()
                           if isinstance(v, float)):
        raise AssertionError(f"(f) logged {recs}")
    evals = json.loads((out / f"_{SWEEP_DICT_RATIO_CHUNKS - 1}"
                        / "dict_ratio_eval.json").read_text())
    if [e["dict_ratio"] for e in evals] != list(MASKED_RATIOS):
        raise AssertionError(f"(f) ratios {[e['dict_ratio'] for e in evals]}")
    rep["f"] = {"wall_s": wall, "launches": main_counts, "parts": parts,
                "eval": evals}
    log(f"  (f) dict_ratio ({len(MASKED_RATIOS)} members, n_stack "
        f"{int(D * max(MASKED_RATIOS))}), {steps} steps in {wall:.1f} s on "
        f"sae_tied_fwd/bwd ({steps} launches each); fvu "
        f"{evals[0]['fvu']:.3f} (ratio {MASKED_RATIOS[0]}) .. "
        f"{evals[-1]['fvu']:.3f} (ratio {MASKED_RATIOS[-1]})")
    shutil.rmtree(out)

    # (h) bfloat16 batches from disk to the card, promoted there: the
    # store is bfloat16 on disk, so the promoted batches are (a)'s exactly
    out = tmp / "sweep_bf16"
    _build.reset_launches()
    sweep_in_process(sweep_args(store, out, "--train_dtype", "bfloat16"),
                     tmp / "obs_bf16")
    counts = {k: _build.LAUNCHES[k] for k in TIED_KERNELS + UNTIED_KERNELS}
    if set(counts.values()) != {SWEEP_STEPS}:
        raise AssertionError(f"(h) launches {counts}")
    assert_bitwise_run(out, out_a, "(h) train_dtype bfloat16")
    rep["h"] = {"launches": counts}
    log(f"  (h) train_dtype bfloat16 (half-width batches to the card): each "
        f"kernel {SWEEP_STEPS} launches; bitwise equal to (a)")
    shutil.rmtree(out)
    return rep


# --- phase 9: the full sweep's host I/O ---------------------------------------

# phase 8's store re-sharded into 2 + 2 chunks; the longer chunk of the
# overlap measurement: 131,072 rows = 64 steps, 2 chunks (262,144 rows
# until phase 20 needed the time, 4 chunks until phase 17: the second
# chunk's training, about 1.5 s, still overlaps the first set's write,
# 0.6-0.9 s under orbax)
SHARDS = (2, 2)
LONG_ROWS_PER_CHUNK, LONG_CHUNKS = 4 * ROWS_PER_CHUNK, 2


def reshard(flat: Path, root: Path, sizes) -> Path:
    """A flat store's chunks, in order, as a sealed sharded store of
    ``sizes`` chunks a shard (the port's ``write_shard_digest`` and
    ``build_store_manifest``): the chunk files are copied, each shard's
    meta.json keeps the flat meta's fields with its digests renumbered."""
    import shutil

    from sparse_coding_tpu_torch.data.shard_store import (
        build_store_manifest,
        shard_name,
        write_shard_digest,
    )

    meta = json.loads((flat / "meta.json").read_text())
    start = 0
    for si, n in enumerate(sizes):
        d = root / shard_name(si)
        d.mkdir(parents=True)
        for li in range(n):
            shutil.copyfile(flat / f"{start + li}.npy", d / f"{li}.npy")
        shard_meta = dict(meta, n_chunks=n, chunk_digests={
            str(li): meta["chunk_digests"][str(start + li)]
            for li in range(n)})
        (d / "meta.json").write_text(json.dumps(shard_meta, indent=2))
        write_shard_digest(d)
        start += n
    build_store_manifest(root, expect_shards=len(sizes))
    return root


def host_io_numbers(events: list[dict]) -> dict:
    """A sweep's host I/O from its obs events: each chunk's wall and
    training time, each checkpoint set's time in the sweep (the whole
    write under msgpack, the issue under orbax), the waits before the
    swaps, the workers' writes, the host→device stage and the read path
    that served the chunks."""
    spans = lambda name: [e for e in events if e.get("span") == name]
    chunks = spans("sweep.chunk")
    later = chunks[1:] or chunks
    metrics = [e for e in events if e.get("kind") == "metrics"]
    counters = metrics[-1]["registry"]["counters"] if metrics else {}
    transfer = spans("ingest.transfer")
    return {
        "acts_per_s": sum(e["rows"] for e in later)
        / sum(e["train_s"] for e in later),
        "chunk_s": [e["dur_s"] for e in chunks],
        "train_s": [e["train_s"] for e in chunks],
        "ckpt_s": [e["dur_s"] for e in spans("sweep.checkpoint")],
        "wait_s": [e["dur_s"] for e in spans("sweep.ckpt_wait")],
        "write_s": [e["dur_s"] for e in spans("ckpt.write")],
        "write_bytes": [e.get("bytes") for e in spans("ckpt.write")],
        "reads": {k.split("path=")[1].rstrip("}"): v
                  for k, v in counters.items()
                  if k.startswith("data.chunk_reads")},
        "decode_s": [e["dur_s"] for e in spans("ingest.decode")],
        "transfer": [{"batches": e["batches"], "wait_s": e["dur_s"]}
                     for e in transfer],
    }


def io_line(n: dict) -> str:
    mean = lambda v: float(np.mean(v)) if v else float("nan")
    return (f"{n['acts_per_s']:.0f} acts/s (chunks 2-{len(n['chunk_s'])}); "
            f"chunk wall {mean(n['chunk_s'][1:]):.2f} s "
            f"(train {mean(n['train_s'][1:]):.2f}); set in the sweep "
            f"{mean(n['ckpt_s']):.3f} s, wait before swap "
            f"{mean(n['wait_s']):.3f} s, worker write "
            f"{mean(n['write_s']):.3f} s; reads {n['reads']}; transfer "
            f"{sum(t['batches'] for t in n['transfer'])} batches, "
            f"{sum(t['wait_s'] for t in n['transfer']):.3f} s host wait")


def host_io_phase(flat: Path, tmp: Path, ref: Path, card: str,
                  flat_io: dict) -> dict:
    """Phase 9 — the orbax backend (deferred swap) over a 2-shard store,
    at phase 8's shape and CLI: (a) bitwise equal to phase 8 (a)'s
    msgpack run over the flat store, each kernel once per step; (b) a
    SIGKILL at sweep.chunk hit 3, while the chunk-3 set is being written,
    resumes from chunk 2 and ends bitwise; (c) SIGTERM: exit 0 with the
    issued set swapped in, then a bitwise resume; (d) a ckpt.save fault
    in a worker fails the child with the typed error and leaves the
    first set in ckpt/; (e) the measurements; (f) both backends at a
    longer chunk (2 of 131,072 rows), bitwise equal to each other."""
    import shutil

    from sparse_coding_tpu_torch.ops import _build

    rep: dict = {}
    orbax = ("--checkpoint_backend", "orbax")
    store = reshard(flat, tmp / "sweep_store_sharded", SHARDS)

    def chunks_done(ckpt_dir: Path) -> int:
        return json.loads((ckpt_dir / "untied_0.tensors.meta.json")
                          .read_text())["chunks_done"]

    # (a) in this process, for the launch counts
    out_a = tmp / "io_a"
    _build.reset_launches()
    wall = sweep_in_process(sweep_args(store, out_a, *orbax), tmp / "obs9_a")
    launches = dict(_build.LAUNCHES)
    if launches != sweep_launches():
        raise AssertionError(f"(a) launches {launches}")
    assert_bitwise_run(out_a, ref, "(a) orbax over 2 shards")
    nums = host_io_numbers(read_events(tmp / "obs9_a"))
    if (len(nums["wait_s"]) != SWEEP_CHUNKS
            or len(nums["write_s"]) != 2 * SWEEP_CHUNKS
            or sum(nums["reads"].values()) != SWEEP_CHUNKS):
        raise AssertionError(f"(a) spans and reads {nums}")
    rep["a"] = {"wall_s": wall, "launches": launches, **nums}
    log(f"  (a) orbax over {len(SHARDS)} shards {SHARDS}: each kernel "
        f"{SWEEP_STEPS} launches; learned dicts, eval.json and ckpt/ "
        f"bitwise equal to phase 8 (a)'s msgpack run over the flat store")
    shutil.rmtree(out_a)

    # (b), (c) and (d) run in child processes, three chains at once:
    # none of them is timed
    def kill_while_written() -> tuple[dict, str]:
        """(b) SIGKILL while the chunk-3 set is issued and not yet swapped
        in."""
        out = tmp / "io_b"
        killed = sweep_subprocess(sweep_args(store, out, *orbax),
                                  tmp / "obs9_b",
                                  crash_plan="sweep.chunk:nth=3")
        if (killed.returncode != -9
                or "SIGKILL at site 'sweep.chunk'" not in killed.stderr):
            raise AssertionError(f"(b) rc {killed.returncode}\n"
                                 f"{killed.stderr[-3000:]}")
        on_disk = chunks_done(out / "ckpt")
        staged = (out / "ckpt_staging").exists()
        if on_disk != 2 or not staged:
            raise AssertionError(f"(b) ckpt/ at chunk {on_disk}, staging "
                                 f"{staged}")
        resumed = sweep_subprocess(sweep_args(store, out, *orbax, "--resume",
                                              "true"), tmp / "obs9_b_resume")
        if resumed.returncode != 0:
            raise AssertionError(f"(b) resume: {resumed.stderr[-3000:]}")
        done = [e["chunks_done"] for e in read_events(tmp / "obs9_b_resume")
                if e.get("span") == "sweep.resume"]
        if done != [2]:
            raise AssertionError(f"(b) resumed from {done}")
        assert_bitwise_run(out, ref, "(b) kill while a set is written")
        shutil.rmtree(out)
        return ({"ckpt_chunks_done": on_disk, "resumed_from": done[0]},
                "  (b) SIGKILL at sweep.chunk hit 3 with the chunk-3 set "
                "issued, not swapped in: ckpt/ held chunk 2's set, resumed "
                "from chunk 2, bitwise equal to phase 8 (a)")

    def sigterm_after_set() -> tuple[dict, str]:
        """(c) SIGTERM once the first set is swapped in."""
        out = tmp / "io_c"
        pre = sweep_subprocess(
            sweep_args(store, out, *orbax), tmp / "obs9_c",
            sigterm_when=out / "ckpt" / "untied_0.tensors.meta.json")
        m = re.search(r"checkpointed after chunk (\d+)", pre.stdout)
        if pre.returncode != 0 or m is None:
            raise AssertionError(f"(c) SIGTERM: rc {pre.returncode}, stdout "
                                 f"{pre.stdout[-500:]}\n{pre.stderr[-3000:]}")
        after = int(m.group(1))
        if (chunks_done(out / "ckpt") != after
                or (out / "ckpt_staging").exists()):
            raise AssertionError(f"(c) preempted after chunk {after}, ckpt/ "
                                 f"at {chunks_done(out / 'ckpt')}")
        resumed = sweep_subprocess(sweep_args(store, out, *orbax, "--resume",
                                              "true"), tmp / "obs9_c_resume")
        if resumed.returncode != 0:
            raise AssertionError(f"(c) resume: {resumed.stderr[-3000:]}")
        assert_bitwise_run(out, ref, "(c) SIGTERM")
        shutil.rmtree(out)
        return ({"preempted_after": after},
                f"  (c) SIGTERM: SweepPreempted after chunk {after} with "
                "that set swapped in on the way out, exit 0; resumed "
                "bitwise equal to phase 8 (a)")

    def failed_write() -> tuple[dict, str]:
        """(d) the second set's first write fails in its worker."""
        out = tmp / "io_d"
        failed = sweep_subprocess(sweep_args(store, out, *orbax),
                                  tmp / "obs9_d",
                                  fault_plan="ckpt.save:nth=3")
        if (failed.returncode in (0, -9)
                or "site=ckpt.save" not in failed.stderr
                or chunks_done(out / "ckpt") != 1):
            raise AssertionError(f"(d) rc {failed.returncode}, ckpt/ at "
                                 f"{chunks_done(out / 'ckpt')}\n"
                                 f"{failed.stderr[-3000:]}")
        error = failed.stderr.strip().splitlines()[-1]
        shutil.rmtree(out)
        return ({"returncode": failed.returncode, "error": error},
                f"  (d) ckpt.save fault in a worker (set 2): exit "
                f"{failed.returncode}, {error!r}; ckpt/ kept the chunk-1 set")

    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        chains = {key: pool.submit(fn) for key, fn in (
            ("b", kill_while_written), ("c", sigterm_after_set),
            ("d", failed_write))}
    for key, chain in chains.items():
        rep[key], line = chain.result()
        log(line)

    # (e) the measurements, beside phase 8's msgpack run over the flat store
    log(f"  (e) {card}")
    log(f"      msgpack, flat (phase 8 (a)): {io_line(flat_io)}")
    log(f"      orbax, {len(SHARDS)} shards: {io_line(nums)}")

    # (f) a longer chunk under each backend
    long_store = tmp / "long_store"
    write_store(long_store, LONG_CHUNKS * LONG_ROWS_PER_CHUNK, SEED + 9,
                rows_per_chunk=LONG_ROWS_PER_CHUNK)
    rep["f"] = {}
    for backend in ("msgpack", "orbax"):
        out = tmp / f"io_f_{backend}"
        sweep_in_process(sweep_args(long_store, out, "--checkpoint_backend",
                                    backend, "--log_every",
                                    str(LONG_ROWS_PER_CHUNK // BATCH)),
                         tmp / f"obs9_f_{backend}")
        rep["f"][backend] = host_io_numbers(
            read_events(tmp / f"obs9_f_{backend}"))
        log(f"  (f) {LONG_CHUNKS} chunks of {LONG_ROWS_PER_CHUNK:,} rows, "
            f"{backend}: {io_line(rep['f'][backend])}")
    a, b = tmp / "io_f_msgpack", tmp / "io_f_orbax"
    for name in ("tied", "untied"):
        bad = dicts_equal(final_dicts(a, name, LONG_CHUNKS - 1),
                          final_dicts(b, name, LONG_CHUNKS - 1))
        for suffix in (".tensors", ".tensors.meta.json"):
            f = Path("ckpt") / f"{name}_0{suffix}"
            if (a / f).read_bytes() != (b / f).read_bytes():
                bad.append(str(f))
        if bad:
            raise AssertionError(f"(f) {name}: the backends differ at {bad}")
    log("  (f) the two backends' learned dicts and ckpt/ bitwise equal")
    for path in (a, b, long_store, store):
        shutil.rmtree(path)
    return rep


# --- phase 10: bf16 compute on the ensemble kernels ---------------------------

# Published H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
BF16 = "bfloat16"
# the bf16 forms (compute_dtype="bfloat16"; the Adam epilogues with
# fused_moments_dtype="bfloat16"), each with the fp32 kernel it extends
BF16_FORMS = {f"{k}_bf16": k for k in (*TIED_KERNELS, *UNTIED_KERNELS)}
BF16_SMALL_SHAPES = ((3, 96, 96, 40), (2, 64, 64, 600), (2, 64, 64, 768))
# the LM widths (as phase 2's WIDTHS)
BF16_WIDE_SHAPES = ((2, 64, 64, 1032), (2, 64, 64, 2048), (2, 64, 64, 4096))
# a bf16 form against its plain bf16 version on the card, |Δ|max against
# RTOL_BF16·max|ref|: the two sides round the same operands at the same
# points and add exact products in fp32 in other orders (tensor-core
# k16 steps vs cuBLAS); a code, dpre or moment within that rounding of a
# bf16 rounding boundary rounds to the neighbouring bf16 on one side,
# which moves its terms by 2⁻⁸ of themselves. ReLU mask flips are counted
# and capped (FLIPS_PER_CODE) and the weight grads held on the features
# without one.
RTOL_BF16 = 1e-3
# the bench.py variants with bf16 compute (bench.py:586-605): (path,
# batch dtype, moments dtype)
BENCH_BF16_VARIANTS = (
    ("train_step", "float32", "float32"),
    ("two_stage", "float32", "float32"),
    ("two_stage", "bfloat16", "float32"),
    ("train_step", "bfloat16", "float32"),
    ("train_step", "bfloat16", "bfloat16"),
)
# each member's single-batch mse on a bf16 variant against the fp32
# kernel path's from the same init on the same batches, |Δ|/mse at steps
# 100 and 200 and the last: bf16 rounds every product's operands, so the
# two trajectories are the same optimization with other numbers
RTOL_BF16_MSE = 2e-2


def bf16_fwd_check(inp: dict, tied: bool, tag: str, x_dtypes=("float32",
                                                               "bfloat16")
                   ) -> dict:
    """A bf16 forward (the tied one with and without the coef_mask) against
    its plain bf16 version, with fp32 and bf16 batches."""
    from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

    e, dec, x, bias, cm = (inp[k] for k in ("e", "dec", "x", "bias", "cm"))
    out = {}
    for xd in x_dtypes:
        xx = x if xd == "float32" else x.to(torch.bfloat16)
        masks = ((None, ""), (cm, "_masked")) if tied else ((None, ""),)
        for mask, sfx in masks:
            if tied:
                got = ft.sae_tied_fwd(e, bias, xx, mask, BF16)
                ref = ft.sae_tied_fwd_plain(e, bias, xx, mask, BF16)
            else:
                got = ft.sae_untied_fwd(e, dec, bias, xx, BF16)
                ref = ft.sae_untied_fwd_plain(e, dec, bias, xx, BF16)
            name = f"r_x{xd}{sfx}"
            out[name] = compare(f"{tag}:{'sae_tied_fwd_bf16' if tied else 'sae_untied_fwd_bf16'}.{name}",
                                got, ref, RTOL_BF16)
    worst = max(v["max_rel_err"] for v in out.values())
    log(f"  {tag} {'sae_tied_fwd_bf16' if tied else 'sae_untied_fwd_bf16'}: "
        f"ok ({', '.join(out)}), worst rel err {worst:.2e}")
    return out


def bf16_bwd_check(inp: dict, tied: bool, tag: str, cm=None,
                   x_dtype: str = "float32", total_batch=None) -> dict:
    """A bf16 backward against its plain bf16 version on the same residual:
    its ReLU mask flips (the kernel's masks from its codes launch on its
    own rounded operands, against the plain version's) at most
    FLIPS_PER_CODE a code; dW (dE, dWn) and db within RTOL_BF16 on every
    (member, feature) without a flip; activity within the flips; losses and
    grad_sq within RTOL_BF16. The untied dWn takes the bf16 codes as an
    operand: a code within its sum-order rounding of a bf16 rounding
    boundary rounds to the neighbouring bf16 on one side (a rounding
    flip), which moves its term by 2⁻⁸ of itself — at a small batch a
    large share of a dWn element. So for the untied backward:

    - its bf16 codes equal its fp32 codes rounded, bit for bit;
    - its fp32 codes lie within RTOL_EXACT of the plain ones, and each
      within the sums' rounding bound of its plain code, 3·(d+1)·2⁻²⁴·S
      with S = Σ_j|x_j·e_j| + |b| (the bound tied_bwd_flips uses): so
      every rounding flip is one that the sum order explains. They are
      counted, not capped at FLIPS_PER_CODE: at 64 rows and d=4096 about
      one code in 2,000 lies that close to a boundary;
    - dWn within RTOL_BF16 of the plain version's with the terms of each
      code whose bf16 value differs from the plain one's (rounding and
      ReLU flips) moved to the kernel's side."""
    from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

    e, dec, x, bias, al = (inp[k] for k in ("e", "dec", "x", "bias",
                                             "alphas"))
    if x_dtype == "bfloat16":
        x = x.to(torch.bfloat16)
    n_m, n, d = e.shape
    b = x.shape[0]
    rnd = lambda t: t.to(torch.bfloat16).to(torch.float32)
    xf = x.to(torch.float32)
    if tied:
        r = ft.sae_tied_fwd_plain(e, bias, x, cm, BF16).contiguous()
        got = ft.sae_tied_bwd(e, bias, al, x, r, cm, BF16, total_batch)
        ref = ft.sae_tied_bwd_plain(e, bias, al, x, r, cm, BF16,
                                    total_batch)
        grads = ("dw",)
        w_plain = rnd(e / torch.clamp(torch.linalg.vector_norm(
            e, dim=-1, keepdim=True), min=1e-8))
        kernel = "sae_tied_bwd_bf16"
    else:
        r = ft.sae_untied_fwd_plain(e, dec, bias, x, BF16).contiguous()
        got = ft.sae_untied_bwd(e, dec, bias, al, x, r, BF16, total_batch)
        ref = ft.sae_untied_bwd_plain(e, dec, bias, al, x, r, BF16,
                                      total_batch)
        grads = ("de", "dwn")
        w_plain = rnd(e)
        kernel = "sae_untied_bwd_bf16"
    # the masks: the kernel's codes launch on its own bf16 operands
    xb = x if x.dtype == torch.bfloat16 else x.to(torch.bfloat16)
    c_k = torch.empty((n_m, b, n), dtype=torch.float32, device=DEV)
    cb = torch.empty((n_m, b, n), dtype=torch.bfloat16, device=DEV)
    if tied:
        wb = torch.empty(e.shape, dtype=torch.bfloat16, device=DEV)
        ft.tied_bwd_bf16_norms(e, wb)
        ft.tied_bwd_bf16_codes(xb, wb, bias, cm, c_k, cb)
    else:
        ft.untied_bwd_bf16_codes(xb, e.to(torch.bfloat16), bias, c_k, cb)
    pre = torch.matmul(rnd(xf), w_plain.transpose(1, 2)) + bias[:, None, :]
    codes = {}
    if not tied:
        c_plain = torch.relu(pre)
        codes["codes"] = compare(f"{tag}:{kernel}.codes", c_k, c_plain,
                                 RTOL_EXACT)
        if not torch.equal(cb, c_k.to(torch.bfloat16)):
            raise AssertionError(f"{tag}: {kernel}'s bf16 codes are not its "
                                 "fp32 codes rounded")
        s_abs = (torch.matmul(rnd(xf).abs(), w_plain.abs().transpose(1, 2))
                 + bias.abs()[:, None, :])
        of_bound = float(((c_k - c_plain).abs()
                          / (3 * (d + 1) * 2.0**-24 * s_abs)
                          .clamp_min(1e-30)).max())
        del s_abs
        if not of_bound <= 1.0:
            raise AssertionError(f"{tag}: {kernel}'s fp32 codes lie "
                                 f"{of_bound:.2e} of the sums' rounding "
                                 "bound from the plain ones (> 1)")
        cpb = c_plain.to(torch.bfloat16)
        fm, fb, ff = (cb != cpb).nonzero().unbind(1)
        codes["codes_of_rounding_bound"] = of_bound
        codes["rounding_flips"] = int(((cb != cpb) & (cb > 0)
                                       & (cpb > 0)).sum())
        # the flipped codes' terms moved to the kernel's side
        coef = 2.0 / ((total_batch or b) * d)
        moved = ((cb[fm, fb, ff].float() - cpb[fm, fb, ff].float())[:, None]
                 * rnd(r[fm, fb]))
        dwn_moved = ref[1].clone().index_put_((fm, ff), coef * moved,
                                              accumulate=True)
        del c_plain, cpb, moved
    del cb
    want = pre > 0
    del pre
    if cm is not None:
        want &= cm[:, None, :] > 0
    flip = (c_k > 0) != want
    del c_k, want
    count = int(flip.sum())
    allowed = max(1.0, FLIPS_PER_CODE * n_m * b * n)
    if count > allowed:
        raise AssertionError(f"{tag}: {kernel} flipped {count} ReLU masks "
                             f"(> {allowed:.0f})")
    clean = ~flip.any(dim=1)  # [N, n]: features with no flip in any row
    flips_per_feature = flip.sum(dim=1).float()
    del flip
    k = len(grads)
    errs = dict(codes)
    for i, g in enumerate(grads):
        if g == "dwn":
            errs["dwn_flips_moved"] = compare(
                f"{tag}:{kernel}.dwn (the flipped codes' terms moved)",
                got[i], dwn_moved, RTOL_BF16)
            del dwn_moved
            continue
        errs[f"{g}_no_flip"] = compare(f"{tag}:{kernel}.{g} (no flip)",
                                       got[i][clean], ref[i][clean],
                                       RTOL_BF16)
    errs["db_no_flip"] = compare(f"{tag}:{kernel}.db (no flip)",
                                 got[k][clean], ref[k][clean], RTOL_BF16)
    act_err = float((got[k + 1] - ref[k + 1]).abs().sub(
        flips_per_feature).max())
    if act_err > 0:
        raise AssertionError(f"{tag}: {kernel} activity off by more than "
                             "its flips")
    errs["loss4"] = compare(f"{tag}:{kernel}.loss4", got[k + 2],
                            ref[k + 2], RTOL_BF16)
    worst = max(v["max_rel_err"] for v in errs.values()
                if isinstance(v, dict))
    rounding = (f", {errs['rounding_flips']} bf16 rounding flips of the "
                f"codes, the farthest code "
                f"{errs['codes_of_rounding_bound']:.2e} of its rounding "
                "bound" if not tied else "")
    log(f"  {tag} {kernel} (x {x_dtype}{', masked' if cm is not None else ''}"
        f"): ok, {count} ReLU mask flips of {n_m * b * n} (allowed "
        f"{allowed:.0f}), worst rel err {worst:.2e}{rounding}")
    return {**errs, "flips": count, "flips_allowed": allowed}


def bf16_adam_check(inp: dict, tag: str) -> dict:
    """The two Adam epilogues with bf16 moments against their plain
    versions: params and the update norm within RTOL_EXACT, each bf16
    moment within one bf16 ulp of the plain one (at most 2⁻⁷ of it: bf16
    keeps 8 significant bits) plus RTOL_EXACT of max|ref| (the fp32
    moment, a few ulps apart on the two sides — the normalization VJP's
    row sums run in other orders, and cancel where dW is nearly radial —,
    may round to a neighbouring bf16)."""
    from sparse_coding_tpu_torch.ops import fused_sae as fs

    h = lambda k: inp[k].to(torch.bfloat16)
    e, dec = inp["e"], inp["dec"]
    tied_args = (e, inp["dw"], h("mu"), h("nu"), inp["lrs"], inp["bc1"],
                 inp["bc2"])
    bias_grp = dict(bias=inp["bias"], db=inp["dw"][:, :, 0].contiguous(),
                    mu_b=inp["mu_b"], nu_b=inp["nu_b"])
    unt_args = (e, inp["dw"], h("mu"), h("nu"), dec, inp["dwn"], h("mu_d"),
                h("nu_d"), inp["lrs"], inp["bc1"], inp["bc2"])
    out = {}

    def moment(label, g, rf):
        if g.dtype != torch.bfloat16:
            raise AssertionError(f"{label}: {g.dtype}")
        gf, rff = g.float(), rf.float()
        err = ((gf - rff).abs() - rff.abs() * 2.0**-7
               - RTOL_EXACT * rff.abs().max()).max()
        if not err <= 0:
            raise AssertionError(f"{label}: more than one bf16 ulp (and "
                                 f"{RTOL_EXACT} of max|ref|) off")
        return {"max_abs_err": float((g.float() - rf.float()).abs().max()),
                "max_rel_err": 0.0, "tol": "one bf16 ulp"}

    got = fs.sae_tied_adam_vjp(*tied_args, **bias_grp)
    ref = fs.sae_tied_adam_vjp_plain(*tied_args, **bias_grp)
    out["sae_tied_adam_vjp_bf16"] = {
        "e": compare(f"{tag}:tied adam.e", got[0], ref[0], RTOL_EXACT),
        "mu": moment(f"{tag}:tied adam.mu", got[1], ref[1]),
        "nu": moment(f"{tag}:tied adam.nu", got[2], ref[2]),
        "un_sq": compare(f"{tag}:tied adam.un_sq", got[3], ref[3],
                         RTOL_EXACT),
        **{n: compare(f"{tag}:tied adam.{n}", g, rf, RTOL_EXACT)
           for n, g, rf in zip(("bias", "mu_b", "nu_b"), got[4], ref[4])}}
    got = fs.sae_untied_adam_vjp(*unt_args)
    ref = fs.sae_untied_adam_vjp_plain(*unt_args)
    names = ("e", "mu_e", "nu_e", "d", "mu_d", "nu_d", "un_sq")
    out["sae_untied_adam_vjp_bf16"] = {
        n: (moment(f"{tag}:untied adam.{n}", g, rf) if n[:2] in ("mu", "nu")
            else compare(f"{tag}:untied adam.{n}", g, rf, RTOL_EXACT))
        for n, g, rf in zip(names, got, ref)}
    for name, errs in out.items():
        worst = max(v["max_rel_err"] for v in errs.values())
        log(f"  {tag} {name}: ok, worst rel err {worst:.2e}, bf16 moments "
            "within one ulp")
    return out


def bf16_repeat(inp: dict) -> dict:
    """Each bf16 form called twice on the same inputs gives the same
    bits."""
    from sparse_coding_tpu_torch.ops import fused_sae as fs
    from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

    e, dec, x, bias, al, cm = (inp[k] for k in ("e", "dec", "x", "bias",
                                                 "alphas", "cm"))
    r = ft.sae_tied_fwd_plain(e, bias, x, None, BF16).contiguous()
    ru = ft.sae_untied_fwd_plain(e, dec, bias, x, BF16).contiguous()
    h = lambda k: inp[k].to(torch.bfloat16)
    calls = {
        "sae_tied_fwd_bf16": lambda: ft.sae_tied_fwd(e, bias, x, cm, BF16),
        "sae_tied_bwd_bf16": lambda: ft.sae_tied_bwd(e, bias, al, x, r, None,
                                                     BF16),
        "sae_untied_fwd_bf16": lambda: ft.sae_untied_fwd(e, dec, bias, x,
                                                         BF16),
        "sae_untied_bwd_bf16": lambda: ft.sae_untied_bwd(e, dec, bias, al, x,
                                                         ru, BF16),
        "sae_tied_adam_vjp_bf16": lambda: fs.sae_tied_adam_vjp(
            e, inp["dw"], h("mu"), h("nu"), inp["lrs"], inp["bc1"],
            inp["bc2"])[:4],
        "sae_untied_adam_vjp_bf16": lambda: fs.sae_untied_adam_vjp(
            e, inp["dw"], h("mu"), h("nu"), dec, inp["dwn"], h("mu_d"),
            h("nu_d"), inp["lrs"], inp["bc1"], inp["bc2"]),
    }
    for name, call in calls.items():
        first, again = call(), call()
        if isinstance(first, torch.Tensor):
            first, again = (first,), (again,)
        if not all(torch.equal(u, v) for u, v in zip(first, again)):
            raise AssertionError(f"{name}: two calls differ")
        del first, again
    log(f"  main: two calls bit-identical: {', '.join(calls)}")
    return {name: True for name in calls}


def bf16_bounds(inp: dict, nnz: dict) -> dict:
    """Least time the card could take for each bf16 form's work on ``inp``:
    max(bytes once / HBM rate, ops / peak), the products' operations at the
    dense bf16 tensor-core peak (989 TFLOP/s) counting active codes as the
    fp32 rows do, the Adam epilogues' elementwise fp32 ones at 67 TFLOP/s;
    the fp32 batch and residual read as fp32, bf16 moments as 2 bytes."""
    n_m, n, d = inp["e"].shape
    b = inp["x"].shape[0]
    f4 = 4
    big = n_m * n * d
    enc = 2.0 * n_m * b * n * d
    act = {k: 2.0 * v * d for k, v in nnz.items()}
    work = {
        "sae_tied_fwd_bf16": (enc + act["tied"], big * 3, f4 * (
            b * d + big + n_m * n + n_m * b * d)),
        "sae_tied_bwd_bf16": (enc + 3 * act["tied"], big * 3, f4 * (
            b * d + 2 * n_m * b * d + 2 * big + 3 * n_m * n + n_m)),
        "sae_untied_fwd_bf16": (enc + act["untied"], big * 3, f4 * (
            b * d + 2 * big + n_m * n + n_m * b * d)),
        "sae_untied_bwd_bf16": (enc + 3 * act["untied"], big * 3, f4 * (
            b * d + 2 * n_m * b * d + 4 * big + 3 * n_m * n + n_m)),
        "sae_tied_adam_vjp_bf16": (0.0, 24.0 * big, 20 * big + f4 * 3 * n_m),
        "sae_untied_adam_vjp_bf16": (0.0, 36.0 * big,
                                     40 * big + f4 * 3 * n_m),
    }
    out = {}
    for name, (mma_ops, simt_ops, nbytes) in work.items():
        t_ops = mma_ops / PEAK_BF16_FLOPS + simt_ops / PEAK_FP32_FLOPS
        t_bytes = nbytes / PEAK_BYTES_PER_S
        out[name] = {"bound_ms": 1e3 * max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes", "flops": mma_ops + simt_ops,
                     "bytes": nbytes}
    return out


def bf16_time_kernels(inp: dict) -> dict:
    """Each bf16 form and its plain bf16 version at the main shape, in
    turns (plain, kernel, kernel, plain), and the four chunked forms'
    launches each timed alone on one chunk."""
    from sparse_coding_tpu_torch.ops import fused_sae as fs
    from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

    e, dec, x, bias, al = (inp[k] for k in ("e", "dec", "x", "bias",
                                             "alphas"))
    r = ft.sae_tied_fwd_plain(e, bias, x, None, BF16).contiguous()
    ru = ft.sae_untied_fwd_plain(e, dec, bias, x, BF16).contiguous()
    h = lambda k: inp[k].to(torch.bfloat16)
    adam = (e, inp["dw"], h("mu"), h("nu"), inp["lrs"], inp["bc1"],
            inp["bc2"])
    uadam = (e, inp["dw"], h("mu"), h("nu"), dec, inp["dwn"], h("mu_d"),
             h("nu_d"), inp["lrs"], inp["bc1"], inp["bc2"])
    pairs = {
        "sae_tied_fwd_bf16": (
            lambda: ft.sae_tied_fwd(e, bias, x, None, BF16),
            lambda: ft.sae_tied_fwd_plain(e, bias, x, None, BF16), 10),
        "sae_tied_bwd_bf16": (
            lambda: ft.sae_tied_bwd(e, bias, al, x, r, None, BF16),
            lambda: ft.sae_tied_bwd_plain(e, bias, al, x, r, None, BF16), 5),
        "sae_tied_adam_vjp_bf16": (lambda: fs.sae_tied_adam_vjp(*adam),
                                   lambda: fs.sae_tied_adam_vjp_plain(*adam),
                                   20),
        "sae_untied_fwd_bf16": (
            lambda: ft.sae_untied_fwd(e, dec, bias, x, BF16),
            lambda: ft.sae_untied_fwd_plain(e, dec, bias, x, BF16), 10),
        "sae_untied_bwd_bf16": (
            lambda: ft.sae_untied_bwd(e, dec, bias, al, x, ru, BF16),
            lambda: ft.sae_untied_bwd_plain(e, dec, bias, al, x, ru, BF16),
            5),
        "sae_untied_adam_vjp_bf16": (
            lambda: fs.sae_untied_adam_vjp(*uadam),
            lambda: fs.sae_untied_adam_vjp_plain(*uadam), 20),
    }
    out = time_pairs(pairs)
    for name, extra in (("sae_tied_fwd_bf16", {}),
                        ("sae_untied_fwd_bf16", {"decoder": dec}),
                        ("sae_tied_bwd_bf16", {"alphas": al, "resid": r}),
                        ("sae_untied_bwd_bf16", {"decoder": dec, "alphas": al,
                                                 "resid": ru})):
        buf = {}
        parts = ft.one_chunk_launches_bf16(name, e, bias, x, buffers=buf,
                                           **extra)
        out[name]["parts"] = time_parts(parts)
        if "_bwd_" in name:
            bmm_beside_products(out[name]["parts"], parts, buf)
        del parts, buf
        torch.cuda.empty_cache()
    return out


def bmm_beside_products(times: dict, parts: dict, buf: dict) -> None:
    """Beside each product of a bf16 backward's chunk (``times``, from
    time_parts), one cuBLAS bf16 ``torch.bmm`` of the same shape on the
    chunk's own operands — [Z, rows, d]·[Z, d, n] for codes and dpre,
    [Z, n, rows]·[Z, rows, d] for the weight grads, bf16 out — timed
    alone (CUDA events, 5 launches): a yardstick of the mainloop's rate,
    which the port never calls."""
    rb, wb, cb = buf["rb"], buf["wb"], buf["cb"]
    nt = torch.empty(cb.shape, dtype=torch.bfloat16, device=DEV)
    tn = torch.empty(wb.shape, dtype=torch.bfloat16, device=DEV)
    bmm = {"nt": lambda: torch.bmm(rb, wb.transpose(1, 2), out=nt),
           "tn": lambda: torch.bmm(cb.transpose(1, 2), rb, out=tn)}
    for name, (_, flops) in parts.items():
        if not flops:
            continue
        kind = "nt" if name.endswith(("_codes", "_dpre")) else "tn"
        ms = time_ms(bmm[kind], 5)
        times[name].update(bmm_ms=ms, bmm_tflops=flops / ms / 1e9)
        log(f"  {name}: cuBLAS bf16 bmm of its shape {ms:.3f} ms, "
            f"{flops / ms / 1e9:.1f} TFLOP/s (yardstick)")


def bf16_ensemble_variants(batches: list, l1_values) -> dict:
    """bench.py's five bf16 variants (BENCH_BF16_VARIANTS) through
    ``Ensemble``, tied and untied, one epoch of the synthetic store each,
    beside the fp32 kernel path (train_step) from the same init on the
    same batches: launch counts zeroed before and read after — each bf16
    form once a step, no fp32 forward or backward —, finite losses, each
    member's mse within RTOL_BF16_MSE of the fp32 run's at steps 100 and
    200 and the last; the step's device time (CUDA events around the
    epoch, after one warm-up step on its own init) and acts/s."""
    from sparse_coding_tpu_torch.ensemble import Ensemble
    from sparse_coding_tpu_torch.ops import _build

    n_steps = len(batches)
    at = sorted({min(99, n_steps - 1), min(199, n_steps - 1), n_steps - 1})
    out = {}
    for family in ("tied", "untied"):
        kernels = TIED_KERNELS if family == "tied" else UNTIED_KERNELS
        fwd, bwd, adam = kernels

        def run(path, batch_dtype, moments, compute):
            sig, members = family_members(family, l1_values)
            opts = {} if compute == "float32" else dict(
                fused_compute_dtype=BF16, fused_moments_dtype=moments)
            ens = Ensemble(members, sig, lr=LR, fused_path=path, device=DEV,
                           **opts)
            data = [bb.to(torch.bfloat16) if batch_dtype == BF16 else bb
                    for bb in batches]
            warm_sig, warm_members = family_members(family, l1_values)
            warm = Ensemble(warm_members, warm_sig, lr=LR, fused_path=path,
                            device=DEV, **opts)
            warm.step_batch(data[0])
            del warm
            sync()
            _build.reset_launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            mse = [ens.step_batch(bb).losses["l_reconstruction"]
                   for bb in data]
            end.record()
            end.synchronize()
            launches = {k: v for k, v in _build.LAUNCHES.items() if v}
            step_ms = start.elapsed_time(end) / n_steps
            mse = torch.stack(mse)
            if not bool(torch.isfinite(mse).all()):
                raise AssertionError(f"{family} {path}: non-finite losses")
            return ens, mse, launches, step_ms

        _, ref_mse, ref_launches, ref_ms = run("train_step", "float32",
                                               "float32", "float32")
        label = f"{family} fp32 train_step"
        out[label] = {"step_ms": ref_ms, "acts_per_s": 1e3 * BATCH / ref_ms,
                      "launches": ref_launches}
        log(f"  {label}: {ref_ms:.3f} ms a step, "
            f"{1e3 * BATCH / ref_ms:,.0f} acts/s")
        for path, batch_dtype, moments in BENCH_BF16_VARIANTS:
            ens, mse, launches, step_ms = run(path, batch_dtype, moments,
                                              BF16)
            label = (f"{family} bf16 {path}, {batch_dtype} batch, "
                     f"{moments} moments")
            want = {f"{fwd}_bf16": n_steps, f"{bwd}_bf16": n_steps}
            if path == "train_step":
                want[adam + ("_bf16" if moments == BF16 else "")] = n_steps
            got = {k: launches.get(k, 0) for k in (
                *want, fwd, bwd, adam, f"{adam}_bf16")}
            want = {k: want.get(k, 0) for k in got}
            if got != want:
                raise AssertionError(f"{label}: launches {got}, expected "
                                     f"{want}")
            for k in ("encoder", "decoder"):
                if k in ens.state.mu and ens.state.mu[k].dtype != (
                        torch.bfloat16 if moments == BF16 else torch.float32):
                    raise AssertionError(f"{label}: {k} moments "
                                         f"{ens.state.mu[k].dtype}")
            rel = ((mse[at] - ref_mse[at]).abs() / ref_mse[at]).max()
            if not float(rel) <= RTOL_BF16_MSE:
                raise AssertionError(f"{label}: mse {float(rel):.2e} from "
                                     "the fp32 kernel path's")
            out[label] = {"step_ms": step_ms,
                          "acts_per_s": 1e3 * BATCH / step_ms,
                          "launches": launches,
                          "mse_max_rel_vs_fp32": float(rel)}
            log(f"  {label}: {step_ms:.3f} ms a step, "
                f"{1e3 * BATCH / step_ms:,.0f} acts/s; launches {got}; "
                f"mse vs fp32 within {float(rel):.2e}")
            del ens
            torch.cuda.empty_cache()
    return out


def bf16_other_paths(batches: list, l1_values) -> dict:
    """The kernel paths bench.py's variants leave out, under bf16 compute
    with bf16 batches: the two tiled paths of the tied and untied families
    (train_step_tiled with bf16 moments too) and the masked family's two
    paths, a few steps each; each bf16 form once a step, no fp32 forward
    or backward, finite losses."""
    from sparse_coding_tpu_torch.ensemble import Ensemble
    from sparse_coding_tpu_torch.ops import _build

    cases = [("tied", "two_stage_tiled", "float32"),
             ("tied", "train_step_tiled", BF16),
             ("untied", "two_stage_tiled", "float32"),
             ("untied", "train_step_tiled", BF16),
             ("masked_tied", "two_stage", "float32"),
             ("masked_tied", "two_stage_tiled", "float32")]
    out = {}
    for family, path, moments in cases:
        fwd, bwd, adam = UNTIED_KERNELS if family == "untied" \
            else TIED_KERNELS
        sig, members = family_members(family, l1_values)
        ens = Ensemble(members, sig, lr=LR, fused_path=path, device=DEV,
                       fused_compute_dtype=BF16, fused_moments_dtype=moments)
        _build.reset_launches()
        losses = torch.stack([ens.step_batch(b.to(torch.bfloat16))
                              .losses["loss"] for b in batches])
        sync()
        n = len(batches)
        want = {f"{fwd}_bf16": n, f"{bwd}_bf16": n, fwd: 0, bwd: 0}
        if path.startswith("train_step"):
            want[adam + ("_bf16" if moments == BF16 else "")] = n
        got = {k: _build.LAUNCHES[k] for k in want}
        label = f"{family} bf16 {path}, {moments} moments"
        if got != want or ens.fused_path != path:
            raise AssertionError(f"{label}: launches {got}, expected {want}")
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"{label}: non-finite losses")
        out[label] = {"launches": got, "losses": losses.tolist()}
        log(f"  {label}: {n} steps, launches {got}, finite losses")
        del ens
        torch.cuda.empty_cache()
    return out


def bf16_phase(x_main: torch.Tensor, batches: list, l1_values,
               g: torch.Generator) -> dict:
    """Phase 10: the bf16 forms against their plain versions (small odd
    shapes, the main shape, ratio 16; fp32 and bf16 batches; the masked
    family's coef_mask), the Adam epilogues with bf16 moments, two calls
    bit-identical; bench.py's bf16 variants through Ensemble; the timings
    and bounds for the kernels line."""
    report = {"checks": {}}
    for shape in BF16_SMALL_SHAPES + BF16_WIDE_SHAPES:
        tag = "bf16 small " + "x".join(map(str, shape))
        inp = make_inputs(g, *shape)
        checks = {"tied_fwd": bf16_fwd_check(inp, True, tag),
                  "untied_fwd": bf16_fwd_check(inp, False, tag)}
        for xd in ("float32", "bfloat16"):
            checks[f"tied_bwd_x{xd}"] = bf16_bwd_check(inp, True, tag,
                                                       x_dtype=xd)
            checks[f"tied_bwd_masked_x{xd}"] = bf16_bwd_check(
                inp, True, tag, cm=inp["cm"], x_dtype=xd)
            checks[f"untied_bwd_x{xd}"] = bf16_bwd_check(inp, False, tag,
                                                         x_dtype=xd)
        checks["adam"] = bf16_adam_check(inp, tag)
        report["checks"][tag] = checks
    inp = make_inputs(g, N_MEMBERS, BATCH, N_FEATS, D, x=x_main)
    tag = "bf16 main"
    checks = {"tied_fwd": bf16_fwd_check(inp, True, tag),
              "untied_fwd": bf16_fwd_check(inp, False, tag),
              "tied_bwd": bf16_bwd_check(inp, True, tag),
              "tied_bwd_masked": bf16_bwd_check(inp, True, tag, cm=inp["cm"]),
              "untied_bwd": bf16_bwd_check(inp, False, tag,
                                           x_dtype="bfloat16"),
              "adam": bf16_adam_check(inp, tag),
              "repeat": bf16_repeat(inp)}
    report["checks"]["main"] = checks
    nnz = active_codes(inp)
    report["bounds"] = bf16_bounds(inp, nnz)
    report["timing"] = bf16_time_kernels(inp)
    report["adam_bound_share"] = bound_shares(
        report["timing"], report["bounds"], ("sae_tied_adam_vjp_bf16",))
    del inp
    torch.cuda.empty_cache()
    n_m, b, n, d = RATIO16_SHAPE
    inp = make_inputs(g, n_m, b, n, d)
    tag = "bf16 ratio16"
    report["checks"]["ratio16"] = {
        "tied_fwd": bf16_fwd_check(inp, True, tag, ("float32",)),
        "untied_fwd": bf16_fwd_check(inp, False, tag, ("bfloat16",)),
        "tied_bwd_masked": bf16_bwd_check(inp, True, tag, cm=inp["cm"]),
        "untied_bwd": bf16_bwd_check(inp, False, tag)}
    del inp
    torch.cuda.empty_cache()
    report["ensemble"] = bf16_ensemble_variants(batches, l1_values)
    report["other_paths"] = bf16_other_paths(batches[:3], l1_values)
    return report


# --- phase 11: bf16 compute in the big SAE ------------------------------------

BIG_BF16_FORMS = {"big_sae_fwd_bf16": "big_sae_fwd",
                  "big_sae_bwd_bf16": "big_sae_bwd"}
# a batch of several K9 chunks with the workspace cap lowered to 64 rows
# (12 bytes a code): 4 x 64 + 32
BIG_BF16_LOWERED = (288, 64, 128, 64)  # (batch, n_feats, d, rows)
# the JAX package's bench_big_sae variants (bench_suite.py:177-228):
# (suite, d, n_feats, batch, iterations)
BENCH_BIG_SHAPES = (("big_sae_train", 1024, 16384, 16384, 15),
                    ("big_sae_train_capacity", 1024, 131072, 16384, 5))
BENCH_BIG_VARIANTS = (("autodiff", {"use_fused": False}),
                      ("fused", {"use_fused": True}),
                      ("fused_bf16", {"use_fused": True,
                                      "fused_compute_dtype": BF16}))
# each step's loss on the bf16 kernels against the fp32 kernels' from the
# same init on the same batches, |Δ|/loss: the JAX package's own
# bf16-versus-f32 bound (tests/test_fused_big_sae.py:151-172)
RTOL_BIG_BF16_LOSS = 2e-2


def big_bf16_check(p: dict, x: torch.Tensor, tag: str,
                   total_batch=None) -> dict:
    """big_sae_fwd_bf16 and big_sae_bwd_bf16 against their plain bf16
    versions, the backward with the untied and the tied residual. The
    kernel's ReLU masks (its codes launch over the whole batch: each code
    is one thread's fixed-order sum, whatever the chunk) are counted
    against the plain version's: at most FLIPS_PER_CODE a code. A flip at
    (b, f) moves dE[:, f] by xc[b]·dpre[b, f], about 1e-3 of max|dE| at
    these shapes, and everything else by far less (c is about 0 there; dt,
    dctr and c_totals sum dpre of the size α/B); so dE is held on the
    features without a flip, x̂, dWn, dt, dctr and c_totals on all, within
    RTOL_BF16 of max|ref|; l1 within RTOL_EXACT; l0 within the flips."""
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    xc = (x - p["centering"]).contiguous()
    alpha = torch.tensor(BIG_L1, device=DEV)
    b, n = x.shape[0], p["dict"].shape[0]
    rnd = lambda t: t.to(torch.bfloat16)
    c = torch.empty((b, n), dtype=torch.float32, device=DEV)
    cb = torch.empty((b, n), dtype=torch.bfloat16, device=DEV)
    fb.bwd_bf16_codes(rnd(xc), rnd(p["encoder"]), p["threshold"], c, cb)
    del cb
    flip = (c > 0) != ((rnd(xc).float() @ rnd(p["encoder"]).float()
                        + p["threshold"]) > 0)
    del c
    flips = int(flip.sum())
    clean = ~flip.any(dim=0)  # [n]: features with no flip in any row
    del flip
    allowed = max(1.0, FLIPS_PER_CODE * b * n)
    if flips > allowed:
        raise AssertionError(f"{tag}: big_sae_bwd_bf16 flipped {flips} ReLU "
                             f"masks (> {allowed:.0f})")
    xhat_ref = fb.big_sae_forward_plain(p, xc, BF16)
    out = {"big_sae_fwd_bf16": {"xhat": compare(
        f"{tag}:big_sae_fwd_bf16.xhat",
        fb.big_sae_forward(p, xc, compute_dtype=BF16), xhat_ref, RTOL_BF16)}}
    errs = {}
    for kind, r in (("untied", xhat_ref - x),
                    ("tied", xhat_ref + p["centering"] - x)):
        r = r.contiguous()
        got = fb.big_sae_backward(p, alpha, xc, r, compute_dtype=BF16,
                                  total_batch=total_batch)
        ref = fb.big_sae_backward_plain(p, alpha, xc, r, BF16, total_batch)
        errs[f"de_no_flip_{kind}"] = compare(
            f"{tag}:big_sae_bwd_bf16.de ({kind} r, no flip)",
            got[0][:, clean], ref[0][:, clean], RTOL_BF16)
        for i, field in enumerate(("dwn", "dt", "dctr", "c_totals"), 1):
            errs[f"{field}_{kind}"] = compare(
                f"{tag}:big_sae_bwd_bf16.{field} ({kind} r)", got[i], ref[i],
                RTOL_BF16)
        errs[f"l1_{kind}"] = compare(f"{tag}:big_sae_bwd_bf16.l1 ({kind} r)",
                                     got[5][0], ref[5][0], RTOL_EXACT)
        errs[f"l0_{kind}"] = compare(f"{tag}:big_sae_bwd_bf16.l0 ({kind} r)",
                                     got[5][1], ref[5][1], 0.0,
                                     max(float(flips), 0.5))
        del got, ref
    errs.update(flips=flips, flips_allowed=allowed,
                features_with_flips=int((~clean).sum()))
    out["big_sae_bwd_bf16"] = errs
    del xhat_ref, xc
    sync()
    torch.cuda.empty_cache()
    for name, e in out.items():
        worst = max(v["max_rel_err"] for k, v in e.items()
                    if isinstance(v, dict) and not is_mask_count(k))
        log(f"  {tag} {name}: ok, worst rel err {worst:.2e}"
            + (f"; {flips} ReLU mask flips of {b * n} codes (allowed "
               f"{allowed:.0f})" if name == "big_sae_bwd_bf16" else ""))
    return out


def big_bf16_launches(steps: int, batch: int = BIG_BATCH,
                      n: int = BIG_N) -> dict:
    """Every launch count after ``steps`` big-SAE steps on the bf16 forms at
    (batch, n): each form once a step, its rounding passes once per rounded
    tensor (xc, E, Wn; and r), its chunk launches once per chunk of its
    bf16 schedule, dctr once; nothing else."""
    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    n_fwd = len(fb.fwd_chunks(batch, n, BF16))
    n_bwd = len(fb.bwd_chunks(batch, n, BF16))
    want = {k: 0 for k in _build.LAUNCHES}
    want.update({k: steps for k in BIG_BF16_FORMS})
    want.update({k: steps * n_fwd for k in _build.BIG_FWD_BF16_PARTS})
    want.update({k: steps * n_bwd for k in _build.BWD_BF16_PARTS})
    want.update({"big_sae_fwd_bf16_round": 3 * steps,
                 "big_sae_bwd_bf16_round": 4 * steps,
                 "big_sae_bwd_bf16_dctr": steps})
    return want


def big_bf16_bounds(b: int, n: int, d: int, nnz: int) -> dict:
    """Least time for each bf16 form's work, counted as the fp32 rows count
    it (big_bounds: the encode product dense, the products over the codes
    over this data's ``nnz`` active codes, each fp32 input read once and
    each output written once), the products at the dense bf16 tensor-core
    peak and the elementwise work at the fp32 one."""
    fp32 = big_bounds(b, n, d, nnz)
    enc, act = 2.0 * b * n * d, 2.0 * nnz * d
    work = {"big_sae_fwd_bf16": (enc + act, 2.0 * b * n,
                                 fp32["big_sae_fwd"]["bytes"]),
            "big_sae_bwd_bf16": (enc + 3 * act, 6.0 * b * n,
                                 fp32["big_sae_bwd"]["bytes"])}
    out = {}
    for name, (mma_ops, simt_ops, nbytes) in work.items():
        t_ops = mma_ops / PEAK_BF16_FLOPS + simt_ops / PEAK_FP32_FLOPS
        t_bytes = nbytes / PEAK_BYTES_PER_S
        out[name] = {"bound_ms": 1e3 * max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes", "flops": mma_ops + simt_ops,
                     "bytes": nbytes}
    return out


def big_bf16_extras(p: dict, x: torch.Tensor) -> dict:
    """At the main shape: each bf16 form twice gives the same bits, one
    call's peak memory beside its plain version's (the form's within its
    outputs, Wn, the bf16 operands and its workspace), each form timed
    beside its plain version in turns, and each of its launches timed alone
    on the first chunk (fused_big_sae.one_chunk_launches)."""
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    xc = (x - p["centering"]).contiguous()
    b, d = xc.shape
    n = p["dict"].shape[0]
    r = (fb.big_sae_forward_plain(p, xc, BF16) - x).contiguous()
    alpha = torch.tensor(BIG_L1, device=DEV)
    fwd_ws = 2 * fb.fwd_chunk_rows(b, n, BF16) * n
    bwd_ws = 12 * fb.bwd_chunk_rows(b, n, BF16) * n
    calls = {
        "big_sae_fwd_bf16": (
            lambda: fb.big_sae_forward(p, xc, compute_dtype=BF16),
            lambda: fb.big_sae_forward_plain(p, xc, BF16),
            4 * (b * d + n * d) + 2 * (b * d + 2 * n * d) + fwd_ws,
            f"output, Wn, bf16 xc/E/Wn, workspace {fwd_ws / 2**20:.0f} MiB",
            fb.fwd_chunks(b, n, BF16)),
        "big_sae_bwd_bf16": (
            lambda: fb.big_sae_backward(p, alpha, xc, r, compute_dtype=BF16),
            lambda: fb.big_sae_backward_plain(p, alpha, xc, r, BF16),
            4 * (3 * n * d + 4 * n + d + 2) + 2 * (2 * b * d + 2 * n * d)
            + bwd_ws,
            f"outputs, Wn, bf16 xc/E/Wn/r, workspace {bwd_ws / 2**20:.0f} "
            "MiB", fb.bwd_chunks(b, n, BF16))}
    out = {}
    for name, (call, plain, allowed, what, chunks) in calls.items():
        out[name] = repeat_and_memory(name, call, plain, allowed, what)
        torch.cuda.empty_cache()
        out[name].update(time_pairs({name: (call, plain, 3)})[name],
                         chunks=len(chunks))
        torch.cuda.empty_cache()
        parts = time_parts(fb.one_chunk_launches(name, p, xc, r, alpha),
                           f" ({chunks[0][1]} rows)")
        once = (f"{name}_round", "big_sae_bwd_bf16_dctr")
        per_call = sum(v["ms"] * (1 if k in once else len(chunks))
                       for k, v in parts.items())
        if name == "big_sae_fwd_bf16":
            log("  big_sae_fwd_bf16 per launch (wgmma): " + ", ".join(
                f"{k.removeprefix(name + '_')} {v['ms']:.3f} ms"
                + (f" ({v['tflops']:.0f} TFLOP/s)" if v["tflops"] else "")
                for k, v in parts.items()))
        log(f"  {len(chunks)} chunks: {name}'s launches sum to "
            f"{per_call:.2f} ms a call")
        out[name].update({"parts": parts, "parts_sum_ms": per_call})
        torch.cuda.empty_cache()
    del xc, r
    torch.cuda.empty_cache()
    return out


def big_bf16_steps(store: Path) -> dict:
    """Phase 7's 16 steps — same seed, init, store, batch order and
    resurrection every 8 — through make_big_sae_step(use_fused=True) in
    fp32 and then with fused_compute_dtype="bfloat16": the bf16 run
    launches each bf16 form once a step and nothing else (counts zeroed
    just before, read just after), its losses are finite and each within
    RTOL_BIG_BF16_LOSS of the fp32 run's; each run's step time on the
    device timeline (CUDA events after each step, steps 2-16)."""
    from sparse_coding_tpu_torch.data.chunk_store import device_prefetch
    from sparse_coding_tpu_torch.data.shard_store import open_store
    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.train import big_sae as bs

    runs = {}
    for compute in ("float32", BF16):
        state, opt, l1 = bs.init_big_sae(torch.Generator().manual_seed(SEED),
                                         BIG_D, BIG_N, BIG_L1, lr=BIG_LR,
                                         device=DEV)
        step = bs.make_big_sae_step(opt, l1, use_fused=True,
                                    fused_compute_dtype=compute)
        store_ = open_store(store, quarantine_corrupt=True)
        rng = np.random.default_rng(SEED)
        losses, events, n = [], [], 0
        sync()
        _build.reset_launches()
        for _ in range(BIG_EPOCHS):
            for batch in device_prefetch(store_.epoch(BIG_BATCH, rng), DEV):
                state, m = step(state, batch)
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
                losses.append(m["loss"])
                n += 1
                if n % BIG_RESURRECT == 0:
                    state, _ = bs.resurrect_dead_features(state)
        sync()
        launches = dict(_build.LAUNCHES)
        step_ms = events[0].elapsed_time(events[-1]) / (n - 1)
        runs[compute] = {"losses": [float(v) for v in losses],
                         "launches": launches, "step_ms": step_ms,
                         "acts_per_s": 1e3 * BIG_BATCH / step_ms}
        del state, step
        torch.cuda.empty_cache()
    want = big_bf16_launches(BIG_STEPS)
    if n != BIG_STEPS or runs[BF16]["launches"] != want:
        raise AssertionError(f"bf16 big-SAE steps: {n} steps, launches "
                             f"{runs[BF16]['launches']}, expected {want}")
    if runs["float32"]["launches"] != big_launches(BIG_STEPS):
        raise AssertionError(f"fp32 big-SAE steps: launches "
                             f"{runs['float32']['launches']}")
    ref, got = runs["float32"]["losses"], runs[BF16]["losses"]
    if not all(math.isfinite(v) for v in got):
        raise AssertionError(f"bf16 big-SAE steps: non-finite losses {got}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
    if not rel <= RTOL_BIG_BF16_LOSS:
        raise AssertionError(f"bf16 big-SAE steps: a loss {rel:.2e} from the "
                             "fp32 kernels'")
    f32, bf = runs["float32"], runs[BF16]
    ran = {k: v for k, v in bf["launches"].items() if v}
    log(f"  {BIG_STEPS} steps on the bf16 forms: {bf['step_ms']:.1f} ms a "
        f"step, {bf['acts_per_s']:,.0f} acts/s, against the fp32 kernels' "
        f"{f32['step_ms']:.1f} ms ({f32['acts_per_s']:,.0f} acts/s); loss "
        f"{got[0]:.4g} -> {got[-1]:.4g}, within {rel:.2e} of fp32's each "
        f"step; launches {ran}")
    return {"runs": runs, "loss_max_rel_vs_fp32": rel}


def bench_big_variants() -> dict:
    """The JAX package's bench_big_sae (bench_suite.py:177-228) through the
    port's make_big_sae_step: autodiff, the fp32 kernels and the bf16
    kernels at d=1024, n=16,384, batch 16,384 (15 iterations) and at the
    capacity shape n=131,072 (5), each from init_big_sae(seed 0) on one
    random batch; activations/s over a window that ends in a read of the
    loss (2 warm-up steps first), as bench_suite's _timed does. An
    out-of-memory error on autodiff is that variant's result, as there; a
    kernel variant's failure is never caught. The kernel variants must
    launch their kernels once a step."""
    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.train import big_sae as bs

    out = {}
    for suite, d, n, batch, iters in BENCH_BIG_SHAPES:
        data = torch.randn((batch, d), generator=torch.Generator(DEV)
                           .manual_seed(1), device=DEV)
        for name, kwargs in BENCH_BIG_VARIANTS:
            label = f"{suite} {name}"
            state, opt, l1 = bs.init_big_sae(torch.Generator().manual_seed(0),
                                             d, n, 1e-3, n_worst=1024,
                                             device=DEV)
            step = bs.make_big_sae_step(opt, l1, **kwargs)
            _build.reset_launches()
            try:
                for _ in range(2):
                    state, m = step(state, data)
                float(m["loss"])
                t0 = time.perf_counter()
                for _ in range(iters):
                    state, m = step(state, data)
                loss = float(m["loss"])
                seconds = time.perf_counter() - t0
            except torch.cuda.OutOfMemoryError as e:
                if kwargs["use_fused"]:
                    raise
                del state, step
                torch.cuda.empty_cache()
                out[label] = {"acts_per_s": 0.0, "failed": repr(e)[:160]}
                log(f"  {label} (d={d}, n={n}, batch {batch}): out of "
                    f"memory — {repr(e)[:120]}")
                continue
            kernels = ({"big_sae_fwd_bf16", "big_sae_bwd_bf16"}
                       if kwargs.get("fused_compute_dtype") == BF16
                       else {"big_sae_fwd", "big_sae_bwd"}
                       if kwargs["use_fused"] else set())
            calls = {k: v for k, v in _build.LAUNCHES.items()
                     if v and k in (*BIG_KERNELS, *BIG_BF16_FORMS)}
            if calls != {k: iters + 2 for k in kernels}:
                raise AssertionError(f"{label}: launches {calls}")
            if not math.isfinite(loss):
                raise AssertionError(f"{label}: loss {loss}")
            rate = iters * batch / seconds
            out[label] = {"acts_per_s": rate, "ms": 1e3 * seconds / iters,
                          "loss": loss, "d": d, "n_feats": n, "batch": batch}
            log(f"  {label} (d={d}, n={n}, batch {batch}): {rate:,.0f} "
                f"acts/s, {1e3 * seconds / iters:.1f} ms a step")
            del state, step
            torch.cuda.empty_cache()
        del data
        torch.cuda.empty_cache()
    return out


def big_bf16_phase(big_store: Path, g: torch.Generator) -> dict:
    """Phase 11: the big SAE's bf16 forms against their plain bf16 versions
    (small shapes up to d=1024, a batch of several chunks under a lowered
    cap and under the real one, the main shape with its ReLU mask flips
    counted), their repeat, memory and times; 16 steps of the bf16 step
    beside the fp32 one; bench_suite's big-SAE variants."""
    from sparse_coding_tpu_torch.data.chunk_store import ChunkStore
    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    checks = {}
    for b, n, d in BIG_SMALL_SHAPES:
        x = torch.randn((b, d), generator=g).to(DEV)
        checks[f"big bf16 {b}x{n}x{d}"] = big_bf16_check(
            big_params(g, n, d), x, f"big bf16 d={d}")
    b, n, d, rows = BIG_BF16_LOWERED
    cap = fb.WORKSPACE_BYTES
    fb.WORKSPACE_BYTES = 12 * n * rows
    try:
        _build.reset_launches()
        checks["lowered cap"] = big_bf16_check(
            big_params(g, n, d), torch.randn((b, d), generator=g).to(DEV),
            "big bf16 lowered cap")
        # one forward, two backwards (untied and tied r), and the codes
        # launch over the whole batch that counts the ReLU flips
        want = big_bf16_launches(1, b, n)
        want.update({k: 2 * v for k, v in want.items()
                     if k.startswith("big_sae_bwd_bf16")})
        want["big_sae_bwd_bf16_codes"] += 1
        if dict(_build.LAUNCHES) != want:
            raise AssertionError(f"big bf16 lowered cap: launches "
                                 f"{dict(_build.LAUNCHES)}, expected {want}")
        log(f"  big bf16 lowered cap: {len(fb.bwd_chunks(b, n, BF16))} "
            "big_sae_bwd_bf16 chunks")
    finally:
        fb.WORKSPACE_BYTES = cap
    b, n, d = BIG_CHUNK_SHAPE
    checks[f"big bf16 {b}x{n}x{d}"] = big_bf16_check(
        big_params(g, n, d), torch.randn((b, d), generator=g).to(DEV),
        "big bf16 chunks")
    log(f"  big bf16 chunks: {len(fb.fwd_chunks(b, n, BF16))} "
        f"big_sae_fwd_bf16 chunks, {len(fb.bwd_chunks(b, n, BF16))} "
        "big_sae_bwd_bf16 chunks")
    x = torch.as_tensor(ChunkStore(big_store).load_chunk(0)[:BIG_BATCH]).to(
        DEV)
    p = big_params(g, BIG_N, BIG_D)
    checks["main"] = big_bf16_check(p, x, "big bf16 main")
    extras = big_bf16_extras(p, x)
    xc = x - p["centering"]
    rnd = lambda t: t.to(torch.bfloat16).float()
    nnz = int(((rnd(xc) @ rnd(p["encoder"]) + p["threshold"]) > 0).sum())
    del xc, x, p
    torch.cuda.empty_cache()
    report = {"checks": checks, "extras": extras, "active_codes": nnz,
              "bounds": big_bf16_bounds(BIG_BATCH, BIG_N, BIG_D, nnz)}
    report["steps"] = big_bf16_steps(big_store)
    report["bench"] = bench_big_variants()
    return report


# --- phase 13: harvest from an LM on the card and train at its width --------

# the EleutherAI/pythia-70m-deduped preset at full width, seeded random
# weights and token ids; DataArgs' context and model batch; its MLP taps
# are d_mlp = 2048 wide. The cut is depth: 2 chunks of 32,768 rows a tap
# (chunk_size_gb 0.125 instead of 2.0), one epoch of 32 steps.
LM_MODEL = "EleutherAI/pythia-70m-deduped"
LM_D_MLP, LM_VOCAB = 2048, 50304  # the preset's, as published
LM_LAYERS = (1, 2)
LM_CHUNK_GB, LM_CHUNKS = 0.125, 2
LM_MEMBERS = 16
LM_CHECK_ROWS = 8  # token rows run on the card and on the CPU
LM_SIDE_STEPS = 3
# the forward on the card vs the CPU, |Δ|max against RTOL_LM·max|ref| per
# tap and for the logits: the same fp32 operations, summed in other
# orders (cuBLAS vs the CPU's BLAS) through 6 layers
RTOL_LM = 1e-4


def lm_params_to(params: dict, device) -> dict:
    return {k: ([{n: t.to(device) for n, t in layer.items()}
                 for layer in v] if k == "layers" else v.to(device))
            for k, v in params.items()}


def half_ulp_close(label: str, got_bits: np.ndarray, ref: torch.Tensor,
                   rtol: float) -> dict:
    """Card chunk rows (bf16 bit patterns) against the CPU's fp32
    activations: each value within one bf16 ulp of itself plus
    rtol·max|ref| (the two forwards' fp32 gap; rounding to bf16 adds at
    most half an ulp on each side)."""
    from sparse_coding_tpu_torch.data.chunk_store import _from_bf16_bits

    got = torch.from_numpy(_from_bf16_bits(got_bits))
    want = ref.to(torch.bfloat16).to(torch.float32)
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    excess = float(((got - want).abs() - ulp
                    - rtol * ref.abs().max()).max())
    if not excess <= 0:
        raise AssertionError(f"{label}: more than one bf16 ulp (and {rtol} "
                             "of max|ref|) from the CPU's taps")
    return {"max_abs_err": float((got - want).abs().max()), "rows":
            int(got.shape[0]), "tol": f"one bf16 ulp + {rtol} of max|ref|"}


def lm_harvest(store: Path) -> tuple[dict, dict, object, np.ndarray]:
    """(a) harvest_activations on the card into a bf16 store; returns the
    report, the card's params, the config and the token rows."""
    from sparse_coding_tpu_torch.config import DataArgs
    from sparse_coding_tpu_torch.data.harvest import harvest_activations
    from sparse_coding_tpu_torch.lm import gptneox
    from sparse_coding_tpu_torch.lm.model_config import get_config

    args = DataArgs()
    cfg = get_config(LM_MODEL)
    if (args.model_name, cfg.d_mlp, cfg.vocab_size) != (LM_MODEL, LM_D_MLP,
                                                        LM_VOCAB):
        raise AssertionError("phase 13 runs DataArgs' default model, "
                             "Pythia-70M's preset")
    ctx, mb = args.context_len, args.model_batch_size
    rows_per_chunk = int(LM_CHUNK_GB * 2**30 / (cfg.d_mlp * 2))
    n_rows = LM_CHUNKS * rows_per_chunk // ctx
    tokens = np.random.default_rng(SEED + 13).integers(
        0, cfg.vocab_size, size=(n_rows, ctx))
    params = gptneox.init_params(torch.Generator().manual_seed(SEED + 13),
                                 cfg, device=DEV)
    # first-call costs (cuBLAS handles) outside the timed harvest
    gptneox.forward(params, torch.as_tensor(tokens[:mb]).to(DEV), cfg,
                    stop_at_layer=1)
    sync()
    t0 = time.perf_counter()
    written = harvest_activations(
        params, cfg, tokens, layers=list(LM_LAYERS), layer_loc="mlp",
        output_folder=store, model_batch_size=mb, chunk_size_gb=LM_CHUNK_GB,
        n_chunks=LM_CHUNKS, dtype="bfloat16", device=DEV)
    wall = time.perf_counter() - t0
    want = {f"mlp.{layer}": LM_CHUNKS for layer in LM_LAYERS}
    if written != want:
        raise AssertionError(f"harvest wrote {written}, expected {want}")
    tokens_per_s = n_rows * ctx / wall
    for tap in want:
        meta = json.loads((store / tap / "meta.json").read_text())
        if (meta["activation_dim"], meta["dtype"], meta["tap"],
                meta["layer_loc"]) != (cfg.d_mlp, "bfloat16", tap, "mlp"):
            raise AssertionError(f"{tap}: meta.json {meta}")
    log(f"  harvest: {n_rows} rows x {ctx} tokens, taps {list(want)}, "
        f"{LM_CHUNKS} chunks of {rows_per_chunk} rows each: {wall:.2f} s, "
        f"{tokens_per_s:.0f} tokens/s (chunk writes included)")
    return ({"wall_s": wall, "tokens_per_s": tokens_per_s, "rows": n_rows,
             "context": ctx, "model_batch": mb,
             "rows_per_chunk": rows_per_chunk}, params, cfg, tokens)


def lm_card_vs_cpu(params: dict, cfg, tokens: np.ndarray,
                   store: Path) -> dict:
    """(b) the first LM_CHECK_ROWS token rows through the forward on the
    card and on the CPU (the same weights): every tap location at every
    layer and the logits within RTOL_LM of max|ref|; the first rows of the
    card's chunk 0 of each tap within one bf16 ulp of the CPU's taps."""
    from sparse_coding_tpu_torch.lm import gptneox, hooks

    toks = torch.as_tensor(tokens[:LM_CHECK_ROWS])
    taps = [hooks.tap_name(layer, loc) for loc in hooks.LAYER_LOCS
            for layer in range(cfg.n_layers)]
    with torch.inference_mode():
        card_logits, card = gptneox.forward(params, toks.to(DEV), cfg, taps)
        cpu_params = lm_params_to(params, "cpu")
        cpu_logits, cpu = gptneox.forward(cpu_params, toks, cfg, taps)
    out = {"logits": compare("lm: logits", card_logits.cpu(), cpu_logits,
                             RTOL_LM)}
    for name in taps:
        out[name] = compare(f"lm: {name}", card[name].cpu(), cpu[name],
                            RTOL_LM)
    del card, card_logits, cpu_logits
    rows = LM_CHECK_ROWS * tokens.shape[1]
    for layer in LM_LAYERS:
        tap = f"mlp.{layer}"
        chunk = np.load(store / tap / "0.npy", mmap_mode="r")[:rows]
        out[f"chunk0 {tap}"] = half_ulp_close(
            f"lm: chunk 0 of {tap}", np.array(chunk),
            cpu[tap].reshape(rows, -1), RTOL_LM)
    worst = max(v["max_rel_err"] for k, v in out.items()
                if not k.startswith("chunk0"))
    log(f"  card vs CPU forward ({LM_CHECK_ROWS} rows, {len(taps)} taps and "
        f"the logits): worst rel err {worst:.2e}; chunk 0's first {rows} "
        "rows of each tap within one bf16 ulp of the CPU's")
    return out


@contextlib.contextmanager
def step_events():
    """A CUDA event recorded after each Ensemble.step_batch (no added
    synchronization), so a run's device-timeline time per step, data
    waits included, can be read after it."""
    from sparse_coding_tpu_torch.ensemble import Ensemble

    events, real = [], Ensemble.step_batch

    def timed(self, batch):
        aux = real(self, batch)
        done = torch.cuda.Event(enable_timing=True)
        done.record()
        events.append(done)
        return aux

    Ensemble.step_batch = timed
    try:
        yield events
    finally:
        Ensemble.step_batch = real


def lm_train(store: Path, out_dir: Path, tied: bool, n_steps: int) -> dict:
    """(c)/(d) basic_l1_sweep over the mlp.2 store on the default kernel
    path: each of the family's kernels once a step (counts zeroed just
    before), finite losses, eval.json ordering the L1 grid, artifacts that
    load; acts/s over steps 2..n on the device timeline."""
    from sparse_coding_tpu_torch.data.chunk_store import ChunkStore
    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.train.basic_sweep import basic_l1_sweep
    from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts

    d = ChunkStore(store).activation_dim
    l1_values = [float(v) for v in np.logspace(-4, -2, LM_MEMBERS)]
    with step_events() as events:
        _build.reset_launches()
        sync()
        t0 = time.perf_counter()
        dicts = basic_l1_sweep(store, out_dir, l1_values, dict_ratio=RATIO,
                               batch_size=BATCH, lr=LR, n_epochs=1,
                               seed=SEED, tied=tied, device=DEV)
        sync()
        wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    ours = TIED_KERNELS if tied else UNTIED_KERNELS
    want = {name: n_steps if name in ours else 0 for name in _build.LAUNCHES}
    want.update(part_launches(tied, n_steps,
                              (LM_MEMBERS, BATCH, RATIO * d)))
    if len(events) != n_steps or launches != want:
        raise AssertionError(f"{len(events)} steps, launches {launches}, "
                             f"expected {n_steps} steps and {want}")
    acts_per_s = ((n_steps - 1) * BATCH
                  / (events[0].elapsed_time(events[-1]) / 1e3))
    evals = json.loads((out_dir / "epoch_0" / "eval.json").read_text())
    if len(evals) != LM_MEMBERS or not all(
            math.isfinite(s["fvu"]) and math.isfinite(s["l0"])
            for s in evals):
        raise AssertionError(f"eval.json: {evals}")
    if not (evals[0]["fvu"] < evals[-1]["fvu"]
            and evals[0]["l0"] > evals[-1]["l0"]):
        raise AssertionError(f"eval.json: the L1 grid does not order fvu "
                             f"and l0: {evals[0]} vs {evals[-1]}")
    loaded = load_learned_dicts(out_dir / "epoch_0" / "learned_dicts.pkl")
    cls = "TiedSAE" if tied else "UntiedSAE"
    if len(loaded) != LM_MEMBERS or len(dicts) != LM_MEMBERS or any(
            type(ld).__name__ != cls
            or tuple(ld.get_learned_dict().shape) != (RATIO * d, d)
            or not torch.isfinite(ld.get_learned_dict()).all()
            for ld, _ in loaded):
        raise AssertionError("learned_dicts.pkl: wrong members")
    del dicts, loaded
    torch.cuda.empty_cache()
    family = "tied" if tied else "untied"
    log(f"  basic_l1_sweep {family}: {n_steps} steps, {wall:.2f} s wall, "
        f"{acts_per_s:.0f} acts/s (steps 2-{n_steps}, device timeline, data "
        f"included); each {family} kernel {n_steps} launches; fvu "
        f"{evals[0]['fvu']:.4f} .. {evals[-1]['fvu']:.4f}, l0 "
        f"{evals[0]['l0']:.1f} .. {evals[-1]['l0']:.1f}")
    return {"wall_s": wall, "acts_per_s": acts_per_s, "launches": launches,
            "eval": evals}


def lm_side_by_side(batches: list) -> dict:
    """(e) both families LM_SIDE_STEPS steps on the kernels and on
    autodiff from one init on the same batches (phase 6's bounds), then
    the same steps with bf16 compute and moments: each bf16 form once a
    step, finite losses within RTOL_BF16_MSE of the fp32 kernels'."""
    from sparse_coding_tpu_torch.ensemble import Ensemble
    from sparse_coding_tpu_torch.models.sae import (
        FunctionalSAE,
        FunctionalTiedSAE,
    )
    from sparse_coding_tpu_torch.ops import _build

    d = batches[0].shape[1]
    l1_values = [float(v) for v in np.logspace(-4, -2, LM_MEMBERS)]
    out = {}
    for family, sig in (("tied", FunctionalTiedSAE),
                        ("untied", FunctionalSAE)):
        g = torch.Generator().manual_seed(SEED + 13)
        members = [sig.init(g, d, RATIO * d, l1_alpha=l1)
                   for l1 in l1_values]
        runs = {}
        for label, kw in (("autodiff", {"use_fused": False}),
                          ("kernels", {}),
                          ("bf16", {"fused_compute_dtype": BF16,
                                    "fused_moments_dtype": BF16,
                                    "fused_path": "train_step_tiled"})):
            ens = Ensemble(members, sig, lr=LR, device=DEV, **kw)
            _build.reset_launches()
            losses = [ens.step_batch(b).losses["loss"] for b in batches]
            sync()
            runs[label] = (ens.state.params, losses, dict(_build.LAUNCHES))
            del ens
        del members
        kernels = TIED_KERNELS if family == "tied" else UNTIED_KERNELS
        n = len(batches)
        if any(runs["kernels"][2][k] != n for k in kernels) or any(
                runs["bf16"][2][f"{k}_bf16"] != n for k in kernels) or any(
                runs["autodiff"][2].values()):
            raise AssertionError(f"{family}: launches "
                                 f"{ {k: v[2] for k, v in runs.items()} }")
        errs = [compare(f"lm {family}: step {i} loss", got, want_l,
                        RTOL_PATH_LOSS)
                for i, (got, want_l) in enumerate(zip(runs["kernels"][1],
                                                      runs["autodiff"][1]))]
        rel = {}
        for w in (("encoder",) if family == "tied"
                  else ("encoder", "decoder")):
            rel[w] = rel_fro(runs["kernels"][0][w], runs["autodiff"][0][w])
            if not rel[w] <= REL_FRO_PATH:
                raise AssertionError(f"lm {family}: {w} drifted from "
                                     f"autodiff, {rel[w]:.2e}")
        bf = [float(((b - k).abs() / k.abs()).max())
              for b, k in zip(runs["bf16"][1], runs["kernels"][1])]
        if not all(torch.isfinite(x).all() for x in runs["bf16"][1]) or \
                not max(bf) <= RTOL_BF16_MSE:
            raise AssertionError(f"lm {family} bf16: losses {bf}")
        out[family] = {"loss_max_rel_err": max(e["max_rel_err"]
                                               for e in errs),
                       "rel_fro": rel, "bf16_loss_rel": bf,
                       "launches": {k: v[2] for k, v in runs.items()}}
        log(f"  {family}: kernels vs autodiff over {n} steps: loss rel err "
            f"{out[family]['loss_max_rel_err']:.2e}, relative Frobenius "
            + ", ".join(f"{w} {v:.2e}" for w, v in rel.items())
            + f"; bf16 forms once a step, losses within {max(bf):.2e} of "
            "fp32's")
        del runs
        torch.cuda.empty_cache()
    return out


def lm_kernels(x: torch.Tensor) -> dict:
    """The ensemble kernels at the slice's shape (LM_MEMBERS members,
    batch BATCH, n = RATIO·d, d = LM_D_MLP) on harvested rows: the chunked
    kernels against their plain versions (check_chunked), the Adam
    epilogues, the bf16 forms; each kernel and its plain version timed,
    with its bound."""
    from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

    d = x.shape[1]
    shape = (LM_MEMBERS, BATCH, RATIO * d, d)
    out = {"chunked": check_chunked(
        torch.Generator(DEV).manual_seed(SEED + 131), x, shape,
        {"fwd": len(ft.fwd_chunks(*shape[:3])),
         "bwd": len(ft.bwd_chunks(*shape[:3]))}, "lm")}
    inp = make_inputs(torch.Generator(DEV).manual_seed(SEED + 132),
                      *shape, x=x)
    adam = {}
    for name, pairs in adam_pairs(inp).items():
        adam[name] = {f: compare(f"lm:{name}.{f}", g, rf, rtol, atol)
                      for f, (g, rf, rtol, atol) in pairs.items()}
    out["adam"] = adam
    worst = max(v["max_rel_err"] for a in adam.values() for v in a.values())
    log(f"  lm adam epilogues: ok, worst rel err {worst:.2e}")
    out["bf16"] = {"tied_fwd": bf16_fwd_check(inp, True, "lm bf16",
                                              ("float32",)),
                   "untied_fwd": bf16_fwd_check(inp, False, "lm bf16",
                                                ("float32",)),
                   "tied_bwd": bf16_bwd_check(inp, True, "lm bf16"),
                   "untied_bwd": bf16_bwd_check(inp, False, "lm bf16"),
                   "adam": bf16_adam_check(inp, "lm bf16")}
    nnz = active_codes(inp)
    out["active_codes"] = nnz
    out["bounds"] = {**bounds(inp, nnz), **bf16_bounds(inp, nnz)}
    out["timing"] = {**time_kernels(inp), **bf16_time_kernels(inp)}
    out["adam_bound_share"] = bound_shares(
        out["timing"], out["bounds"],
        ("sae_tied_adam_vjp", "sae_tied_adam_vjp_bf16"), f" (d={d})")
    del inp
    torch.cuda.empty_cache()
    return out


def lm_scrub(store: Path) -> dict:
    """(f) scrub_store over each tap folder of the harvested store reads
    clean; one flipped byte in chunk 1 of mlp.1 is named, and with repair
    the chunk is quarantined."""
    from sparse_coding_tpu_torch.data.ledger import load_quarantine
    from sparse_coding_tpu_torch.data.scrub import QUARANTINE_DIR, scrub_store

    out = {}
    for layer in LM_LAYERS:
        rep = scrub_store(store / f"mlp.{layer}")
        if (rep["checked"], rep["ok"], rep["quarantined"]) != (
                LM_CHUNKS, LM_CHUNKS, 0):
            raise AssertionError(f"scrub of mlp.{layer}: {rep}")
        out[f"clean mlp.{layer}"] = rep
    folder = store / "mlp.1"
    path = folder / "1.npy"
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0x10
    path.write_bytes(bytes(raw))
    found = scrub_store(folder)
    work = json.loads((folder / "scrub" / "reharvest.json").read_text())
    if found["quarantined"] != 1 or [w["chunk"] for w in work] != [1]:
        raise AssertionError(f"scrub after a flipped byte: {found}, {work}")
    repaired = scrub_store(folder, repair=True)
    if (not (folder / QUARANTINE_DIR / "1.npy").exists() or path.exists()
            or list(load_quarantine(folder)) != [1]
            or repaired["quarantined"] != 1):
        raise AssertionError(f"scrub --repair: {repaired}")
    log(f"  scrub: {LM_CHUNKS} + {LM_CHUNKS} chunks clean; a flipped byte "
        "in mlp.1 chunk 1 named on the worklist and, with repair, moved to "
        "quarantine/ and the ledger")
    return {**out, "found": found, "repaired": repaired}


def lm_phase(tmp: Path) -> tuple[dict, dict]:
    """Phase 13: (a) harvest, (b) card vs CPU, (c)/(d) train tied and
    untied on the mlp.2 store, (e) kernels vs autodiff, (f) scrub; and
    the kernels at the slice's shape. Returns the report and what phase
    14 evaluates: the LM's params on the card, its config, the store and
    the tied mlp.2 dicts' artifact."""
    from sparse_coding_tpu_torch.data.chunk_store import ChunkStore

    store = tmp / "lm_store"
    t0 = time.perf_counter()
    report = {}
    report["harvest"], params, cfg, tokens = lm_harvest(store)
    report["card_vs_cpu"] = lm_card_vs_cpu(params, cfg, tokens, store)
    torch.cuda.empty_cache()
    n_steps = LM_CHUNKS * report["harvest"]["rows_per_chunk"] // BATCH
    train = store / f"mlp.{LM_LAYERS[-1]}"
    for tied in (True, False):
        family = "tied" if tied else "untied"
        report[f"train_{family}"] = lm_train(train, tmp / f"lm_{family}",
                                             tied, n_steps)
    chunk = torch.as_tensor(ChunkStore(train).load_chunk(0))
    batches = [chunk[i * BATCH:(i + 1) * BATCH].to(DEV).contiguous()
               for i in range(LM_SIDE_STEPS)]
    report["side_by_side"] = lm_side_by_side(batches)
    report["kernels"] = lm_kernels(batches[0])
    del batches, chunk
    torch.cuda.empty_cache()
    report["scrub"] = lm_scrub(store)
    report["wall_s"] = time.perf_counter() - t0
    log(f"  phase 13: {report['wall_s']:.1f} s")
    return report, {"params": params, "cfg": cfg, "store": store,
                    "tied_dicts": tmp / "lm_tied" / "epoch_0"
                    / "learned_dicts.pkl"}


# -- phase 14: the evaluation stage on the card --------------------------------

# (a) the toy gate: ToyArgs' defaults, then the JAX gate's config
# (tests/test_plotting_toy.py test_toy_replication_gate)
TOY_GATE = dict(activation_dim=48, n_ground_truth_features=64,
                feature_num_nonzero=5, learned_dict_ratio=1.5, l1_alpha=1e-3,
                lr=3e-3, batch_size=512, epochs=3, dataset_size=120_000)
TOY_GATE_REPRESENTEDNESS = 0.85
EVAL_MEMBERS = 4  # (b): tied members over mlp.1
# (c) perplexity: 64 token rows and a tail of 8, model batch 16
PPL_ROWS, PPL_TAIL, PPL_BATCH, PPL_CPU_ROWS, PPL_CPU_BATCH = 64, 8, 16, 8, 4
RTOL_IDENTITY = 1e-6
GRAPH_ROWS, GRAPH_SEQ, GRAPH_FEATS, GRAPH_TARGETS = 8, 64, 8, 64
IOI_PROMPTS, IOI_CHECK_FEATS, IOI_CARD_FEATS, IOI_TOP = 8, 32, 1024, 8
PROBE_N, PROBE_SEQ, PROBE_POS, KL_ROWS, KL_SEQ = 256, 16, 5, 4, 64
ERASE_GRID = (1, 2, 4, 8, 16, 32, 64)
AUROC_TOL = 1e-3
LEACE_CHANCE = 0.15  # 4 standard deviations of chance over 128 + 128
SWEEP_CHECK_ROWS, SWEEP_CHECK_DICTS = 8192, 2
FISTA_ROWS, RTOL_FISTA = 64, 1e-3
# card vs CPU of an evaluation through the LM: the forward's bound, of
# the largest value an output is formed from (perplexities, probe
# activations; the logits for the IOI metric, effects and curve, a
# difference of logits; the target codes, times √positions, for an
# ablation graph's weights, norms of code differences)
RTOL_EVAL = RTOL_LM
# the KL under an erasure is second order in log-probability differences
# that each carry the forward's rounding of log-probs near −log(vocab)
# (1.42e-5 measured at these shapes on an H100)
RTOL_KL = 1e-3


def have(module: str) -> bool:
    import importlib.util

    return importlib.util.find_spec(module) is not None


class StubTokenizer:
    """Word-level stub: each word one id from zlib.crc32 (the same in
    every process, unlike hash), inside the vocabulary, 0 kept for
    padding."""

    pad_token_id = 0

    def __init__(self, vocab: int):
        self.vocab = vocab

    def _encode(self, text: str) -> list[int]:
        import zlib

        return [zlib.crc32(w.encode()) % (self.vocab - 1) + 1
                for w in text.split()]

    def __call__(self, texts):
        if isinstance(texts, str):
            return {"input_ids": self._encode(texts)}
        return {"input_ids": [self._encode(t) for t in texts]}


@contextlib.contextmanager
def seen_ensembles():
    """The Ensembles that step inside the block (basic_l1_sweep keeps its
    own)."""
    from sparse_coding_tpu_torch.ensemble import Ensemble

    seen, real = [], Ensemble.step_batch

    def step(self, batch):
        if not any(e is self for e in seen):
            seen.append(self)
        return real(self, batch)

    Ensemble.step_batch = step
    try:
        yield seen
    finally:
        Ensemble.step_batch = real


def tied_launches(want: int, label: str) -> dict:
    from sparse_coding_tpu_torch.ops import _build

    got = {k: _build.LAUNCHES[k] for k in TIED_KERNELS}
    if any(v != want for v in got.values()):
        raise AssertionError(f"{label}: tied launches {got}, expected "
                             f"{want} each")
    return got


def eval_toy(tmp: Path) -> dict:
    """(a) run_toy_replication at ToyArgs' defaults and at the JAX gate's
    config on the card: each tied kernel once a step, finite metrics, the
    gate's best representedness above 0.85."""
    from sparse_coding_tpu_torch.config import ToyArgs
    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.train.toy_models import run_toy_replication

    out = {}
    plots = have("matplotlib")
    for label, cfg in (("defaults", ToyArgs()), ("gate", ToyArgs(**TOY_GATE))):
        steps = cfg.epochs * cfg.dataset_size // cfg.batch_size
        folder = tmp / f"toy_{label}" if plots else None
        _build.reset_launches()
        sync()
        t0 = time.perf_counter()
        res = run_toy_replication(cfg, output_folder=folder, device=DEV)
        sync()
        wall = time.perf_counter() - t0
        launches = tied_launches(steps, f"(a) toy {label}")
        if not all(math.isfinite(v) for r in res for v in r.values()):
            raise AssertionError(f"(a) toy {label}: {res}")
        if plots and not (folder / "toy_recovery.png").exists():
            raise AssertionError(f"(a) toy {label}: no plot")
        best = max(r["representedness"] for r in res)
        if label == "gate" and not best > TOY_GATE_REPRESENTEDNESS:
            raise AssertionError(f"(a) toy gate: representedness {best}")
        out[label] = {"steps": steps, "wall_s": wall, "launches": launches,
                      "results": res, "plot": plots}
        log(f"  (a) toy {label} (d={cfg.activation_dim}, "
            f"{cfg.n_ground_truth_features} true features, batch "
            f"{cfg.batch_size}): {steps} steps in {wall:.2f} s, each tied "
            f"kernel {steps} launches; representedness "
            f"{[round(r['representedness'], 4) for r in res]}, FVU "
            f"{[round(r['fvu'], 4) for r in res]}")
    return out


def eval_mlp1_sweep(mlp1: Path, tmp: Path) -> tuple[dict, object, list]:
    """(b) basic_l1_sweep, EVAL_MEMBERS tied members at ratio RATIO, over
    phase 13's mlp.1 store (its sound chunk: the scrub quarantined chunk
    1): each tied kernel once a step. Returns the report, the sweep's
    Ensemble and its dicts."""
    from sparse_coding_tpu_torch.data.chunk_store import ChunkStore, ChunkWriter
    from sparse_coding_tpu_torch.data.shard_store import first_sound_chunk
    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.train.basic_sweep import basic_l1_sweep

    src = ChunkStore(mlp1)
    chunk = src.load_chunk(first_sound_chunk(src))
    store = tmp / "eval_mlp1"
    w = ChunkWriter(store, chunk.shape[1],
                    chunk_size_gb=chunk.shape[0] * chunk.shape[1] * 2 / 2**30,
                    dtype="bfloat16")
    w.add(chunk)
    w.finalize({"tap": "mlp.1", "layer_loc": "mlp", "layer": 1})
    n_steps = chunk.shape[0] // BATCH
    l1_values = [float(v) for v in np.logspace(-4, -2, EVAL_MEMBERS)]
    with seen_ensembles() as ens:
        _build.reset_launches()
        sync()
        t0 = time.perf_counter()
        dicts = basic_l1_sweep(store, tmp / "eval_mlp1_out", l1_values,
                               dict_ratio=RATIO, batch_size=BATCH, lr=LR,
                               n_epochs=1, seed=SEED, tied=True, device=DEV)
        sync()
        wall = time.perf_counter() - t0
    launches = tied_launches(n_steps, "(b) mlp.1 sweep")
    evals = json.loads((tmp / "eval_mlp1_out" / "epoch_0" / "eval.json"
                        ).read_text())
    if len(ens) != 1 or not all(math.isfinite(e["fvu"]) for e in evals):
        raise AssertionError(f"(b) mlp.1 sweep: {len(ens)} ensembles, "
                             f"{evals}")
    log(f"  (b) basic_l1_sweep over mlp.1 ({EVAL_MEMBERS} tied members, n="
        f"{RATIO * chunk.shape[1]}, batch {BATCH}): {n_steps} steps in "
        f"{wall:.2f} s, each tied kernel {n_steps} launches; fvu "
        f"{[round(e['fvu'], 4) for e in evals]}")
    return ({"steps": n_steps, "wall_s": wall, "launches": launches,
             "eval": evals}, ens[0], [ld for ld, _ in dicts])


def eval_perplexity(params, cpu, cfg, dicts: list, evals: list) -> dict:
    """(c) calculate_perplexity at (2, "mlp") over PPL_ROWS + PPL_TAIL
    token rows, model batch PPL_BATCH (a short tail batch), for the model,
    the Identity dict and phase 13's 16 dicts; the identity's perplexity
    equals the model's; the card against the CPU over PPL_CPU_ROWS rows
    for two dicts."""
    from sparse_coding_tpu_torch.metrics.intervention import (
        calculate_perplexity,
    )
    from sparse_coding_tpu_torch.models import Identity

    rows = np.random.default_rng(SEED + 14).integers(
        0, cfg.vocab_size, size=(PPL_ROWS + PPL_TAIL, 256))
    autoencoders = [(Identity.create(cfg.d_mlp, device=DEV), {})] + [
        (ld, {}) for ld in dicts]
    calculate_perplexity(params, cfg, autoencoders[:1], 2, "mlp", rows[:8],
                         model_batch_size=PPL_BATCH)  # first-call costs
    sync()
    t0 = time.perf_counter()
    orig, per = calculate_perplexity(params, cfg, autoencoders, 2, "mlp",
                                     rows, model_batch_size=PPL_BATCH)
    wall = time.perf_counter() - t0
    passes = len(autoencoders) + 1
    tokens_per_s = passes * rows.size / wall
    if not abs(per[0] - orig) <= RTOL_IDENTITY * orig:
        raise AssertionError(f"(c) identity perplexity {per[0]} vs {orig}")
    if not all(math.isfinite(p) and p > 0 for p in [orig] + per):
        raise AssertionError(f"(c) perplexities {orig}, {per}")
    pick = [dicts[0], dicts[-1]]
    card_small = calculate_perplexity(
        params, cfg, [(ld, {}) for ld in pick], 2, "mlp",
        rows[:PPL_CPU_ROWS], model_batch_size=PPL_CPU_BATCH)
    cpu_small = calculate_perplexity(
        cpu, cfg, [(ld.to("cpu"), {}) for ld in pick], 2, "mlp",
        rows[:PPL_CPU_ROWS], model_batch_size=PPL_CPU_BATCH)
    err = compare("(c) perplexity card vs CPU",
                  torch.tensor([card_small[0]] + card_small[1]),
                  torch.tensor([cpu_small[0]] + cpu_small[1]), RTOL_EVAL)
    table = [{"l1_alpha": e["l1_alpha"], "perplexity": p, "l0": e["l0"],
              "fvu": e["fvu"]} for p, e in zip(per[1:], evals)]
    log(f"  (c) calculate_perplexity at mlp.2: {passes} passes over "
        f"{rows.shape[0]} rows x 256 tokens (model batch {PPL_BATCH}, tail "
        f"{PPL_TAIL}) in {wall:.2f} s, {tokens_per_s:.0f} tokens/s; original "
        f"{orig:.4f}, identity {per[0]:.4f}; card vs CPU ({PPL_CPU_ROWS} rows, "
        f"2 dicts) rel err {err['max_rel_err']:.2e}")
    for t in table:
        log(f"      l1 {t['l1_alpha']:.2e}: perplexity {t['perplexity']:.4f}"
            f", l0 {t['l0']:.1f}, fvu {t['fvu']:.4f}")
    return {"original": orig, "identity": per[0], "dicts": table,
            "wall_s": wall, "tokens_per_s": tokens_per_s, "passes": passes,
            "rows": int(rows.shape[0]), "card_vs_cpu": err}


def active_features(params, cfg, ld, layer: int, toks,
                    k: int) -> tuple[list[int], float]:
    """The k features of ``ld`` with the largest mean code at (layer,
    mlp) over ``toks``, and the largest code."""
    from sparse_coding_tpu_torch.metrics.intervention import (
        cache_all_activations,
    )

    codes = cache_all_activations(params, cfg, {(layer, "mlp"): ld},
                                  toks)[(layer, "mlp")]
    return (torch.argsort(-codes.mean(dim=(0, 1)))[:k].tolist(),
            float(codes.abs().max()))


def graph_values(graph: dict) -> tuple[list, torch.Tensor]:
    keys = sorted(graph, key=repr)
    return keys, torch.tensor([graph[k] for k in keys], dtype=torch.float64)


def eval_graph(params, cpu, cfg, d1, d2) -> dict:
    """(d) build_ablation_graph_non_positional from an mlp.1 dict of (b)
    to one of phase 13's mlp.2 dicts, GRAPH_FEATS source features (the
    most active) to GRAPH_TARGETS targets, on GRAPH_ROWS rows: card vs
    CPU."""
    from sparse_coding_tpu_torch.metrics.intervention import (
        build_ablation_graph_non_positional,
    )

    toks = np.random.default_rng(SEED + 141).integers(
        0, cfg.vocab_size, size=(GRAPH_ROWS, GRAPH_SEQ))
    l1, l2 = (1, "mlp"), (2, "mlp")
    sources, _ = active_features(params, cfg, d1, 1, toks, GRAPH_FEATS)
    feats = {l1: sources}
    dests, code_max = active_features(params, cfg, d2, 2, toks,
                                      GRAPH_TARGETS)
    targets = {l2: dests}
    sync()
    t0 = time.perf_counter()
    card = build_ablation_graph_non_positional(params, cfg, {l1: d1, l2: d2},
                                               toks, feats, targets)
    wall = time.perf_counter() - t0
    on_cpu = build_ablation_graph_non_positional(
        cpu, cfg, {l1: d1.to("cpu"), l2: d2.to("cpu")}, toks, feats, targets)
    keys, got = graph_values(card)
    ckeys, want = graph_values(on_cpu)
    if keys != ckeys:
        raise AssertionError("(d) graph edges differ card vs CPU")
    err = compare("(d) ablation graph card vs CPU", got, want, 0.0,
                  RTOL_EVAL * code_max * math.sqrt(GRAPH_SEQ))
    if not float(want.max()) > 0:
        raise AssertionError("(d) the ablations moved nothing")
    log(f"  (d) ablation graph mlp.1 -> mlp.2: {GRAPH_FEATS} sources, "
        f"{len(card)} edges on {GRAPH_ROWS}x{GRAPH_SEQ} tokens, {wall:.2f} s "
        f"on the card; card vs CPU abs err {err['max_abs_err']:.2e} (largest "
        f"weight {float(want.max()):.3e}, largest code {code_max:.3e})")
    return {"edges": len(card), "wall_s": wall, "card_vs_cpu": err,
            "max_weight": float(want.max()), "max_code": code_max}


def eval_ioi(params, cpu, cfg, ld) -> dict:
    """(e) run_ioi_feature_ident at mlp.2 with one dict: the card over
    IOI_CARD_FEATS features (timed), and card vs CPU over
    IOI_CHECK_FEATS: the rankings equal, the effects and the cumulative
    ablation curve within RTOL_EVAL."""
    from sparse_coding_tpu_torch.tasks.feature_ident import (
        run_ioi_feature_ident,
    )

    tok = StubTokenizer(cfg.vocab_size)
    kw = dict(n_prompts=IOI_PROMPTS, layer_loc="mlp", curve=True,
              top_m=IOI_TOP)
    sync()
    t0 = time.perf_counter()
    wide = run_ioi_feature_ident(params, cfg, ld, 2, tok,
                                 feature_indices=range(IOI_CARD_FEATS), **kw)
    wall = time.perf_counter() - t0
    feats = list(range(IOI_CHECK_FEATS))
    card = run_ioi_feature_ident(params, cfg, ld, 2, tok,
                                 feature_indices=feats, **kw)
    cpu_params = cpu
    cpu = run_ioi_feature_ident(cpu_params, cfg, ld.to("cpu"), 2, tok,
                                feature_indices=feats, **kw)
    from sparse_coding_tpu_torch.lm import gptneox
    from sparse_coding_tpu_torch.tasks.ioi_counterfact import (
        gen_ioi_dataset_with_distractors,
    )

    toks = gen_ioi_dataset_with_distractors(tok, IOI_PROMPTS, "mixed", 0)[0]
    with torch.no_grad():
        logits, _ = gptneox.forward(cpu_params, torch.as_tensor(toks).long(),
                                    cfg)
    bound = RTOL_EVAL * float(logits.abs().max())
    eff = compare("(e) IOI effects card vs CPU",
                  torch.from_numpy(card["effects"][feats]).double(),
                  torch.from_numpy(cpu["effects"][feats]).double(),
                  0.0, bound)
    curve = compare("(e) IOI ablation curve card vs CPU",
                    torch.from_numpy(card["ablation_curve"]["metrics"]),
                    torch.from_numpy(cpu["ablation_curve"]["metrics"]),
                    0.0, bound)
    # the card's ranking must rank the CPU's effects: equal, or apart
    # only where two |effects| lie within the bound of each other
    ce = np.abs(cpu["effects"])
    equal = card["ranking"] == cpu["ranking"]
    if len(card["ranking"]) != len(cpu["ranking"]) or not (equal or all(
            abs(ce[a] - ce[b]) <= 2 * bound
            for a, b in zip(card["ranking"], cpu["ranking"]))):
        raise AssertionError(f"(e) IOI ranking card {card['ranking']} vs "
                             f"CPU {cpu['ranking']}")
    if not np.any(cpu["effects"][feats]):
        raise AssertionError("(e) no feature moved the IOI metric")
    log(f"  (e) IOI feature ident at mlp.2: {IOI_PROMPTS} prompts, "
        f"{IOI_CARD_FEATS} features ranked in {wall:.2f} s on the card "
        f"({IOI_CARD_FEATS / wall:.0f} ablated forwards/s), top "
        f"{wide['ranking'][:4]}; card vs CPU over {IOI_CHECK_FEATS} "
        f"features: ranking {'equal' if equal else 'within the bound'}, "
        f"effects abs err {eff['max_abs_err']:.2e}, curve abs err "
        f"{curve['max_abs_err']:.2e} (bound {bound:.2e}; base metric "
        f"{cpu['base_metric']:.4e}, largest effect {ce.max():.3e})")
    return {"wall_s": wall, "features": IOI_CARD_FEATS,
            "ranking": wide["ranking"], "check_ranking": card["ranking"],
            "ranking_equal": equal, "effects": eff, "curve": curve,
            "bound": bound, "base_metric": cpu["base_metric"]}


def closed_form_probe(acts, labels, max_iter=None) -> float:
    """AUROC of a ridge probe solved in closed form in float64 on the
    activations' device (the erasure functions' ``probe_fn``; for a host
    without sklearn): w = (XᵀX + I)⁻¹ Xᵀ(z − z̄), the AUROC the
    Mann-Whitney statistic of the scores."""
    x = acts.double()
    z = torch.as_tensor(labels, device=x.device).double()
    xc = x - x.mean(dim=0)
    w = torch.linalg.solve(xc.T @ xc + torch.eye(x.shape[1], device=x.device,
                                                 dtype=x.dtype),
                           xc.T @ (z - z.mean()))
    s = (xc @ w).cpu().numpy()
    y = z.cpu().numpy() > 0.5
    order = np.argsort(s, kind="stable")
    ranks = np.empty(len(s))
    ranks[order] = np.arange(1, len(s) + 1)
    n1, n0 = int(y.sum()), int((~y).sum())
    return float((ranks[y].sum() - n1 * (n1 + 1) / 2) / (n1 * n0))


def eval_erasure(params, cpu, cfg, ld, tmp: Path, dict_file: Path) -> dict:
    """(f) probe_activations at layer 2 (mlp) of prompts whose label is a
    planted token, then leace_baseline and feature_erasure_curve with the
    LM's KL under each edit on the card; the same on the CPU from the
    same prompts and probe."""
    from sparse_coding_tpu_torch.metrics.erasure import (
        feature_erasure_curve,
        leace_baseline,
    )
    from sparse_coding_tpu_torch.metrics.erasure_driver import (
        probe_activations,
    )

    sk = have("sklearn")
    probe = None if sk else closed_form_probe
    rs = np.random.default_rng(SEED + 142)
    labels = (np.arange(PROBE_N) % 2).astype(np.int32)
    prompts = rs.integers(1, cfg.vocab_size, size=(PROBE_N, PROBE_SEQ))
    prompts[:, PROBE_POS] = np.where(labels == 1, cfg.vocab_size // 3,
                                     2 * cfg.vocab_size // 3)
    kl_toks = rs.integers(0, cfg.vocab_size, size=(KL_ROWS, KL_SEQ))
    out = {"probe": "sklearn logistic regression" if sk
           else "closed-form ridge (chip_smoke.closed_form_probe)"}
    runs = {}
    for side, p, d in (("card", params, ld),
                       ("cpu", cpu, ld.to("cpu"))):
        sync()
        t0 = time.perf_counter()
        acts = probe_activations(p, cfg, prompts, 2, "mlp")
        lm_eval = {"params": p, "lm_cfg": cfg, "tokens": kl_toks,
                   "location": (2, "mlp"), "forward": None}
        curve = feature_erasure_curve(d, acts, labels, ERASE_GRID,
                                      lm_eval=lm_eval, probe_fn=probe)
        leace = leace_baseline(acts, labels, probe_fn=probe)
        runs[side] = {"acts": acts.cpu(), "curve": curve, "leace": leace,
                      "wall_s": time.perf_counter() - t0}
    out["acts"] = compare("(f) probe activations card vs CPU",
                          runs["card"]["acts"], runs["cpu"]["acts"],
                          RTOL_EVAL)
    for key, rtol in (("edit_magnitude", RTOL_EVAL), ("kl", RTOL_KL)):
        out[key] = compare(
            f"(f) {key} card vs CPU",
            torch.tensor([r[key] for r in runs["card"]["curve"]]),
            torch.tensor([r[key] for r in runs["cpu"]["curve"]]), rtol)
    aurocs = [(g["auroc"], c["auroc"]) for g, c in
              zip(runs["card"]["curve"], runs["cpu"]["curve"])]
    worst = max(abs(a - b) for a, b in aurocs)
    if not worst <= AUROC_TOL:
        raise AssertionError(f"(f) AUROC card vs CPU {aurocs}")
    # LEACE leaves no linear trace of the labels: a linear probe fits
    # rounding noise, so each side's AUROC is chance, not the other's
    chance = [runs[k]["leace"]["auroc"] for k in ("card", "cpu")]
    if not all(abs(a - 0.5) <= LEACE_CHANCE for a in chance):
        raise AssertionError(f"(f) AUROC after LEACE {chance}")
    out["leace_edit"] = compare(
        "(f) LEACE edit magnitude card vs CPU",
        torch.tensor([runs["card"]["leace"]["edit_magnitude"]]),
        torch.tensor([runs["cpu"]["leace"]["edit_magnitude"]]), RTOL_EVAL)
    out.update(auroc_max_abs_err=worst,
               curve=runs["card"]["curve"], leace=runs["card"]["leace"],
               wall_s={k: v["wall_s"] for k, v in runs.items()})
    c = runs["card"]["curve"]
    log(f"  (f) erasure at mlp.2 ({out['probe']}): {PROBE_N} prompts, "
        f"AUROC {c[0]['auroc']:.4f} -> {c[-1]['auroc']:.4f} erasing "
        f"{c[-1]['n_erased']} features (KL {c[-1]['kl']:.3e}), LEACE "
        f"{chance[0]:.4f} (CPU {chance[1]:.4f}, both chance); card "
        f"{runs['card']['wall_s']:.2f} s, CPU {runs['cpu']['wall_s']:.2f} s; "
        f"card vs CPU: AUROC within {worst:.1e}, edit rel err "
        f"{out['edit_magnitude']['max_rel_err']:.2e}, KL rel err "
        f"{out['kl']['max_rel_err']:.2e}")
    if sk and have("matplotlib"):
        from sparse_coding_tpu_torch.config import ErasureArgs
        from sparse_coding_tpu_torch.metrics.erasure_driver import run_erasure
        from sparse_coding_tpu_torch.utils.artifacts import save_learned_dicts

        save_learned_dicts([(ld, {"member": 0})], dict_file)
        args = ErasureArgs(layers=[2], layer_loc="mlp",
                           dict_path=str(dict_file),
                           output_folder=str(tmp / "erasure_out"))
        t0 = time.perf_counter()
        rec = run_erasure(args, params, cfg, prompts, labels,
                          kl_tokens=kl_toks)
        wall = time.perf_counter() - t0
        written = json.loads((tmp / "erasure_out" /
                              "erasure_scores_layer_2.json").read_text())
        if written["layer"] != 2 or len(written["dicts"]) != 1:
            raise AssertionError(f"(f) run_erasure wrote {written}")
        out["run_erasure"] = {"wall_s": wall, "leace": rec[2]["leace"]}
        log(f"  (f) run_erasure end to end: {wall:.2f} s, json and plot "
            "written")
    return out


def eval_sweeps(store2: Path, dict_file: Path, tmp: Path) -> dict:
    """(g) activity_sweep and kurtosis_sweep over the mlp.2 store with
    phase 13's dict file on the card (timed); then both over the store's
    first SWEEP_CHECK_ROWS rows with SWEEP_CHECK_DICTS of the dicts on the
    card and on the CPU: counts equal, kurtosis within RTOL_MOMENTS."""
    from sparse_coding_tpu_torch.data.chunk_store import ChunkStore, ChunkWriter
    from sparse_coding_tpu_torch.metrics.geometry import (
        activity_sweep,
        kurtosis_sweep,
    )
    from sparse_coding_tpu_torch.utils.artifacts import (
        load_learned_dicts,
        save_learned_dicts,
    )

    store = ChunkStore(store2)
    t0 = time.perf_counter()
    act = activity_sweep([dict_file], store, device=DEV)
    t1 = time.perf_counter()
    kurt = kurtosis_sweep([dict_file], store, device=DEV)
    t2 = time.perf_counter()
    chunk = store.load_chunk(0)
    rows = chunk.shape[0] * store.n_chunks
    small = tmp / "sweep_check"
    chunk = chunk[:SWEEP_CHECK_ROWS]
    w = ChunkWriter(small, chunk.shape[1],
                    chunk_size_gb=chunk.nbytes / 2 / 2**30, dtype="bfloat16")
    w.add(chunk)
    w.finalize()
    few = tmp / "sweep_check.pkl"
    save_learned_dicts(load_learned_dicts(dict_file)[:SWEEP_CHECK_DICTS], few)
    side = {}
    for dev in (DEV, "cpu"):
        side[dev] = (activity_sweep([few], ChunkStore(small), device=dev),
                     kurtosis_sweep([few], ChunkStore(small), device=dev))
    if side[DEV][0] != side["cpu"][0]:
        raise AssertionError(f"(g) activity card {side[DEV][0]} vs CPU "
                             f"{side['cpu'][0]}")
    keys = ("mean_kurtosis", "median_kurtosis", "mean_skew")
    err = compare("(g) kurtosis sweep card vs CPU",
                  torch.tensor([[r[k] for k in keys] for r in side[DEV][1]]),
                  torch.tensor([[r[k] for k in keys] for r in side["cpu"][1]]),
                  RTOL_MOMENTS)
    log(f"  (g) activity_sweep {t1 - t0:.2f} s and kurtosis_sweep "
        f"{t2 - t1:.2f} s over the mlp.2 store ({rows} rows, {len(act)} "
        f"dicts) on the card; n_ever_active "
        f"{[a['n_ever_active'] for a in act][:4]}...; card vs CPU over "
        f"{SWEEP_CHECK_ROWS} rows, {SWEEP_CHECK_DICTS} dicts: counts equal, "
        f"kurtosis rel err {err['max_rel_err']:.2e}")
    return {"activity_s": t1 - t0, "kurtosis_s": t2 - t1, "rows": rows,
            "activity": act, "kurtosis": kurt, "card_vs_cpu": err}


def eval_dicts(dicts2: list, x: torch.Tensor) -> dict:
    """(g) FISTA codes over one mlp.2 dict and a ConcatEnsembleDict of two
    encoding the same rows, card vs CPU."""
    from sparse_coding_tpu_torch.models.combination import ConcatEnsembleDict
    from sparse_coding_tpu_torch.models.direct_coef import DirectCoefOptimizer

    fista = DirectCoefOptimizer(dictionary=dicts2[0].dictionary, l1_alpha=1e-2)
    sync()
    t0 = time.perf_counter()
    card = fista.encode(x.to(DEV))
    sync()
    wall = time.perf_counter() - t0
    cpu = fista.to("cpu").encode(x.cpu())
    out = {"fista": compare("(g) FISTA codes card vs CPU", card.cpu(), cpu,
                            RTOL_FISTA), "fista_s": wall,
           "fista_l0": float((card != 0).float().sum(-1).mean())}
    concat = ConcatEnsembleDict.create(dicts2[:2])
    out["concat"] = compare("(g) ConcatEnsembleDict encode card vs CPU",
                            concat.encode(x.to(DEV)).cpu(),
                            concat.to("cpu").encode(x.cpu()), RTOL_EVAL)
    log(f"  (g) FISTA ({FISTA_ROWS} rows, n={fista.n_feats}, 50 iterations) "
        f"{wall:.3f} s on the card, mean l0 {out['fista_l0']:.1f}, card vs "
        f"CPU rel err {out['fista']['max_rel_err']:.2e}; ConcatEnsembleDict "
        f"of 2 ({concat.n_feats} features) rel err "
        f"{out['concat']['max_rel_err']:.2e}")
    return out


def eval_resurrection(ens) -> dict:
    """(g) resurrect_ensemble_features on the card over (b)'s Ensemble
    with a marked dead set: only dead rows change, each to its member's
    mean live-row norm; their biases and moments zero; the rest bitwise."""
    from sparse_coding_tpu_torch.ensemble import resurrect_ensemble_features

    st = ens.state
    n_members, n, _ = st.params["encoder"].shape
    g = torch.Generator(DEV).manual_seed(SEED + 143)
    dead = torch.rand((n_members, n), generator=g, device=DEV) < 0.05
    new = resurrect_ensemble_features(st, dead, g)
    live = ~dead
    enc, old = new.params["encoder"], st.params["encoder"]
    norms = torch.linalg.vector_norm(old, dim=-1)
    want = (norms * live).sum(-1) / live.sum(-1).clamp(min=1)
    got = torch.linalg.vector_norm(enc, dim=-1)
    err = compare("(g) resurrected row norms", got[dead],
                  want[:, None].expand_as(got)[dead], RTOL_EXACT)
    ok = (torch.equal(enc[live], old[live])
          and not torch.equal(enc[dead], old[dead])
          and bool((new.params["encoder_bias"][dead] == 0).all())
          and torch.equal(new.params["encoder_bias"][live],
                          st.params["encoder_bias"][live])
          and all(bool((getattr(new, m)[k][dead] == 0).all())
                  and torch.equal(getattr(new, m)[k][live],
                                  getattr(st, m)[k][live])
                  for m in ("mu", "nu") for k in ("encoder", "encoder_bias")))
    if not ok:
        raise AssertionError("(g) resurrection broke its contract")
    n_dead = int(dead.sum())
    log(f"  (g) resurrect_ensemble_features: {n_dead} dead of "
        f"{n_members * n} across {n_members} members; fresh rows at the "
        f"live-row mean norm (rel err {err['max_rel_err']:.2e}), bias and "
        "moments zero, live rows bitwise")
    return {"dead": n_dead, "norms": err}


def eval_baselines(store512: Path, tmp: Path) -> dict:
    """(g) the baseline runner on the card: PCA (eigh in float64) card vs
    CPU through rot·diag(λ)·rotᵀ; with sklearn on the host,
    run_layer_baselines whole over the 512-wide store (ICA on up to 8,192
    rows); without it, its device part — PCA, the RandomDict and identity
    exports."""
    from sparse_coding_tpu_torch.data.chunk_store import ChunkStore
    from sparse_coding_tpu_torch.models import IdentityReLU, RandomDict
    from sparse_coding_tpu_torch.models.pca import BatchedPCA, fit_pca

    chunk = ChunkStore(store512).load_chunk(0)
    d = chunk.shape[1]
    recon = {}
    for dev in (DEV, "cpu"):
        pca = BatchedPCA(d, device=dev)
        pca.state = fit_pca(chunk, batch_size=512, device=dev)
        vals, vecs = pca.get_pca()
        recon[dev] = ((vecs * vals) @ vecs.T).cpu()
        if dev == DEV:
            exports = {"pca": pca.to_learned_dict(sparsity=d),
                       "pca_topk": pca.to_topk_dict(min(128, d)),
                       "pca_rotation": pca.to_rotation_dict(),
                       "random": RandomDict.create(
                           torch.Generator().manual_seed(SEED), d).to(DEV),
                       "identity_relu": IdentityReLU.create(d, device=DEV)}
    out = {"pca": compare("(g) PCA card vs CPU", recon[DEV], recon["cpu"],
                          RTOL_MOMENTS)}
    x = torch.as_tensor(chunk[:256], device=DEV)
    for name, ld in exports.items():
        if not torch.isfinite(ld.predict(x)).all():
            raise AssertionError(f"(g) {name} export")
    if have("sklearn"):
        from sparse_coding_tpu_torch.train.baselines import run_layer_baselines

        t0 = time.perf_counter()
        res = run_layer_baselines(store512, tmp / "baselines",
                                  sparsity=min(128, d),
                                  max_ica_samples=8192, device=DEV)
        out["run_layer_baselines_s"] = time.perf_counter() - t0
        if sorted(res) != sorted(["pca", "pca_topk", "pca_rotation", "ica",
                                  "ica_topk", "random", "identity_relu"]):
            raise AssertionError(f"(g) baselines {sorted(res)}")
        log(f"  (g) run_layer_baselines whole (ICA on 8,192 rows): "
            f"{out['run_layer_baselines_s']:.2f} s")
    log(f"  (g) baselines' device part at d={d}: PCA card vs CPU rel err "
        f"{out['pca']['max_rel_err']:.2e}; exports {list(exports)}")
    return out


def eval_phase(tmp: Path, lm: dict, store512: Path) -> dict:
    """Phase 14: (a) the toy gate, (b) a second dict location, (c)
    perplexity under reconstruction, (d) an ablation graph, (e) IOI
    feature identification, (f) erasure, (g) geometry, FISTA, concat,
    resurrection and the baselines — on phase 13's LM, stores and
    dicts."""
    from sparse_coding_tpu_torch.data.chunk_store import ChunkStore
    from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts

    t0 = time.perf_counter()
    params, cfg, store = lm["params"], lm["cfg"], lm["store"]
    dict_file = lm["tied_dicts"]
    evals = json.loads((dict_file.parent / "eval.json").read_text())
    dicts2 = [ld for ld, _ in load_learned_dicts(dict_file, device=DEV)]
    host = {m: have(m) for m in ("sklearn", "matplotlib")}
    log(f"  host packages: {host}")
    report = {"host": host, "toy": eval_toy(tmp)}
    report["mlp1"], ens, dicts1 = eval_mlp1_sweep(store / "mlp.1", tmp)
    cpu = lm_params_to(params, "cpu")
    report["perplexity"] = eval_perplexity(params, cpu, cfg, dicts2, evals)
    report["graph"] = eval_graph(params, cpu, cfg, dicts1[0], dicts2[0])
    report["ioi"] = eval_ioi(params, cpu, cfg, dicts2[0])
    report["erasure"] = eval_erasure(params, cpu, cfg, dicts2[0], tmp,
                                     tmp / "erasure_dict.pkl")
    del cpu
    report["sweeps"] = eval_sweeps(store / "mlp.2", dict_file, tmp)
    x = torch.as_tensor(ChunkStore(store / "mlp.2").load_chunk(1)[
        :FISTA_ROWS])
    report["dicts"] = eval_dicts(dicts2, x)
    report["resurrection"] = eval_resurrection(ens)
    report["baselines"] = eval_baselines(store512, tmp)
    report["wall_s"] = time.perf_counter() - t0
    log(f"  phase 14: {report['wall_s']:.1f} s")
    return report


# -- phase 15: interpreting features on the card -------------------------------

# (a) InterpArgs' own defaults (5,000 fragments of 64 tokens, batch 20, 10
# features from the top 10 and 10 random fragments each, offline) at
# layer 2 of the MLP, over INTERP_ROWS seeded random token rows of
# INTERP_CTX tokens
INTERP_ROWS, INTERP_CTX, INTERP_LAYER = 5000, 128, 2
INTERP_CHECK_FRAGMENTS = 64  # (b) card vs CPU
# (c): one window of 8 batches of 20 and a tail batch, (a)'s first 180
# fragments (the field changes nothing in the port; this holds its contract)
INTERP_SCAN, INTERP_SCAN_ROWS = 8, 180
INVESTIGATE_FEATS = 4  # (d)
GRAPH_CPU_SOURCES = 2  # (d) card vs CPU on these sources' edges
# (e) the smallest tied experiment (zero_l1_baseline, 3 members, tied) over
# the mlp.2 store, a snapshot a chunk; the drivers cut to 256 fragments
# and 4 features
SNAP_CHUNKS, SNAP_FRAGMENTS, SNAP_FEATS = 2, 256, 4
CATALOG_CHECK_ROWS, CATALOG_CHECK_DICTS = 4096, 2  # (f) card vs CPU
QUERY_K, QUERY_ROWS = 8, 512
PLOT_ROWS = 8192  # (g)
# card vs CPU: a feature's mean magnitude (float64 sums of the codes, the
# forward of phase 13's bound away) and an MMCS (a mean of 8,192 maxes,
# whose rounding averages out); a single cosine of two unit rows of 2,048
# is a sum of 2,048 products in another order (≈ 1e-7–1e-6 apart)
RTOL_CATALOG_MAG, CATALOG_MMCS_TOL, COS_TOL = 1e-5, 1e-6, 1e-5
SCORE_TOL = 1e-4  # (b) the correlation scores, card vs CPU


def digests(folder: Path) -> dict[str, str]:
    import hashlib

    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.iterdir())}


def interp_fragment_pass(params, cfg, ld, rows: np.ndarray,
                         tmp: Path) -> tuple[dict, np.ndarray, object, list]:
    """(a) the fragment pass and ``run`` at InterpArgs' defaults on the
    card: tokens/s of the pass, features explained per second (the run's
    wall less its own fragment pass, which is the timed pass's work);
    then a second ``run`` into the same folder rewrites nothing. Returns
    the report, the fragments, their maxes and the features explained."""
    from sparse_coding_tpu_torch.config import InterpArgs
    from sparse_coding_tpu_torch.interp.fragments import (
        build_fragment_activations,
        sample_fragments,
    )
    from sparse_coding_tpu_torch.interp.run import run

    args = InterpArgs(layer=INTERP_LAYER, layer_loc="mlp",
                      output_folder=str(tmp / "interp_a"))
    if (args.n_fragments, args.fragment_len, args.batch_size,
            args.n_feats_to_explain, args.top_k_fragments,
            args.n_random_fragments, args.provider) != (
            5000, 64, 20, 10, 10, 10, "offline"):
        raise AssertionError(f"(a) runs InterpArgs' defaults, not {args}")
    frags = sample_fragments(rows, args.fragment_len, args.n_fragments,
                             seed=args.seed)
    build_fragment_activations(params, cfg, ld, frags[:args.batch_size],
                               INTERP_LAYER, "mlp",
                               batch_size=args.batch_size)  # first calls
    sync()
    t0 = time.perf_counter()
    fa, _ = build_fragment_activations(params, cfg, ld, frags, INTERP_LAYER,
                                       "mlp", batch_size=args.batch_size)
    sync()
    pass_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    recs = run(ld, args, params, cfg, rows, decode_token=str)
    run_s = time.perf_counter() - t0
    feats = [r["feature"] for r in recs]
    if len(set(feats)) != args.n_feats_to_explain or not all(
            math.isfinite(r[k]) for r in recs
            for k in ("top_score", "random_score", "top_random_score",
                      "max_activation")):
        raise AssertionError(f"(a) records {recs}")
    out = Path(args.output_folder)
    for f in feats:
        if not (out / f"feature_{f}" / "explanation.txt").exists():
            raise AssertionError(f"(a) feature_{f}: no explanation.txt")
    scores = {p: (p.read_bytes(), p.stat().st_mtime_ns)
              for p in out.glob("feature_*/scores.json")}
    again = run(ld, args, params, cfg, rows, decode_token=str)
    if again != recs or {p: (p.read_bytes(), p.stat().st_mtime_ns)
                         for p in scores} != scores:
        raise AssertionError("(a) the second run rewrote scores.json")
    explain_s = run_s - pass_s
    report = {"fragments": int(frags.shape[0]),
              "tokens": int(frags.size), "pass_s": pass_s,
              "tokens_per_s": frags.size / pass_s, "run_s": run_s,
              "features": feats, "features_per_s": len(feats) / explain_s,
              "max_activation": [r["max_activation"] for r in recs]}
    log(f"  (a) fragment pass at InterpArgs' defaults ({frags.shape[0]} "
        f"fragments x {args.fragment_len} tokens, batch {args.batch_size}, "
        f"mlp.{INTERP_LAYER}, n={ld.n_feats}): {pass_s:.2f} s, "
        f"{report['tokens_per_s']:.0f} tokens/s; run {run_s:.2f} s, "
        f"{report['features_per_s']:.2f} features explained/s; features "
        f"{feats}; a second run rewrote no scores.json")
    return report, frags, fa, feats


def interp_card_vs_cpu(params, cpu, cfg, ld, rows: np.ndarray, feats: list,
                       tmp: Path) -> dict:
    """(b) INTERP_CHECK_FRAGMENTS fragments on the card and on the CPU
    (the same weights, dict and features): the maxes within RTOL_EVAL of
    max|ref|; each feature's top fragments equal but where two maxes lie
    within that bound; the explanations equal wherever the top records
    agree, the scores within SCORE_TOL."""
    from sparse_coding_tpu_torch.config import InterpArgs
    from sparse_coding_tpu_torch.interp.fragments import (
        build_fragment_activations,
        sample_fragments,
    )
    from sparse_coding_tpu_torch.interp.run import run

    args = InterpArgs(layer=INTERP_LAYER, layer_loc="mlp",
                      n_fragments=INTERP_CHECK_FRAGMENTS)
    frags = sample_fragments(rows, args.fragment_len, args.n_fragments,
                             seed=args.seed)
    ld_cpu = ld.to("cpu")
    sides = (("card", params, ld), ("cpu", cpu, ld_cpu))
    fa = {side: build_fragment_activations(
        p, cfg, d, frags, INTERP_LAYER, "mlp", batch_size=args.batch_size)[0]
        for side, p, d in sides}
    ref = fa["cpu"].max_per_fragment
    err = compare("(b) fragment maxes card vs CPU",
                  fa["card"].max_per_fragment.cpu(), ref, RTOL_EVAL)
    recs = {side: run(d, args.replace(output_folder=str(
        tmp / f"interp_b_{side}")), p, cfg, rows, decode_token=str,
        feature_indices=feats) for side, p, d in sides}
    agree, score_err = 0, 0.0
    for f, rc, rr in zip(feats, recs["card"], recs["cpu"]):
        gi = fa["card"].top_fragments(f, args.top_k_fragments)[0].cpu()
        ri = fa["cpu"].top_fragments(f, args.top_k_fragments)[0]
        # a different pick must be a near-tie on the CPU's maxes
        gap = (ref[gi, f] - ref[ri, f]).abs().max()
        if not float(gap) <= 2 * err["tol"]:
            raise AssertionError(f"(b) feature {f}: top fragments {gi} vs "
                                 f"{ri}, maxes {float(gap):.3e} apart")
        if torch.equal(gi, ri):
            agree += 1
            if rc["explanation"] != rr["explanation"]:
                raise AssertionError(f"(b) feature {f}: explanations "
                                     f"{rc['explanation']!r} vs "
                                     f"{rr['explanation']!r}")
            for k in ("top_score", "random_score", "top_random_score"):
                score_err = max(score_err, abs(rc[k] - rr[k]))
    if not score_err <= SCORE_TOL:
        raise AssertionError(f"(b) scores card vs CPU {score_err:.3e}")
    log(f"  (b) {INTERP_CHECK_FRAGMENTS} fragments card vs CPU: maxes rel "
        f"err {err['max_rel_err']:.2e}; top fragments equal for {agree} of "
        f"{len(feats)} features (the rest near-ties), explanations equal "
        f"there, scores within {score_err:.2e}")
    return {"maxes": err, "top_equal": agree, "features": len(feats),
            "score_err": score_err}


def interp_scan(params, cfg, ld, frags: np.ndarray, fa1) -> dict:
    """(c) scan_batches=INTERP_SCAN over (a)'s first INTERP_SCAN_ROWS
    fragments (a window and a tail batch) against (a)'s scan_batches=1
    maxes of the same batches: bit-identical."""
    from sparse_coding_tpu_torch.interp.fragments import (
        build_fragment_activations,
    )

    batch = 20
    fa8, _ = build_fragment_activations(
        params, cfg, ld, frags[:INTERP_SCAN_ROWS], INTERP_LAYER, "mlp",
        batch_size=batch, scan_batches=INTERP_SCAN)
    windows, tail = divmod(INTERP_SCAN_ROWS, batch * INTERP_SCAN)
    if not tail or not torch.equal(
            fa8.max_per_fragment,
            fa1.max_per_fragment[:INTERP_SCAN_ROWS]):
        raise AssertionError(f"(c) scan_batches={INTERP_SCAN} maxes differ "
                             f"from scan_batches=1 (tail {tail} rows)")
    log(f"  (c) scan_batches={INTERP_SCAN}: {windows} window + a tail of "
        f"{tail} rows, maxes bit-identical to scan_batches=1")
    return {"windows": windows, "tail_rows": tail}


def active_positions(params, cfg, ld, layer: int, toks,
                     k: int) -> tuple[list[tuple[int, int]], float]:
    """The k (position, feature) pairs of ``ld`` with the largest mean
    code over the rows at (layer, mlp), and the largest code."""
    from sparse_coding_tpu_torch.metrics.intervention import (
        cache_all_activations,
    )

    codes = cache_all_activations(params, cfg, {(layer, "mlp"): ld},
                                  toks)[(layer, "mlp")]
    mean = codes.mean(dim=0)  # [s, n]
    top = torch.argsort(-mean.flatten())[:k].tolist()
    n = mean.shape[1]
    return [(i // n, i % n) for i in top], float(codes.abs().max())


def interp_graphs(params, cfg, rows: np.ndarray, mlp1_file: Path,
                  mlp2_file: Path, feats: list, tmp: Path) -> dict:
    """(d) run_interp_graph at InterpGraphArgs' defaults (64 fragments of
    32 tokens) from phase 14 (b)'s mlp.1 dict to phase 13's mlp.2 dict,
    positional and not, 8 sources to 64 targets (the most active), on the
    card (timed); then investigate_features on 4 live mlp.2 features.
    Returns the report and what :func:`graph_checks` holds against the
    CPU."""
    from sparse_coding_tpu_torch.config import InterpGraphArgs, InvestigateArgs
    from sparse_coding_tpu_torch.interp.fragments import sample_fragments
    from sparse_coding_tpu_torch.interp.graph import (
        investigate_features,
        run_interp_graph,
    )
    from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts

    g = InterpGraphArgs(layers=[1, 2], layer_loc="mlp",
                        dict_paths=[str(mlp1_file), str(mlp2_file)])
    d1 = load_learned_dicts(mlp1_file, device=DEV)[0][0]
    d2 = load_learned_dicts(mlp2_file, device=DEV)[0][0]
    toks = sample_fragments(rows, g.fragment_len, g.n_fragments, seed=g.seed)
    l1, l2 = (1, "mlp"), (2, "mlp")
    out, card = {}, {}
    for positional in (False, True):
        if positional:
            src, _ = active_positions(params, cfg, d1, 1, toks, GRAPH_FEATS)
            dst, code_max = active_positions(params, cfg, d2, 2, toks,
                                             GRAPH_TARGETS)
        else:
            src, _ = active_features(params, cfg, d1, 1, toks, GRAPH_FEATS)
            dst, code_max = active_features(params, cfg, d2, 2, toks,
                                            GRAPH_TARGETS)
        kind = "positional" if positional else "non_positional"
        args = g.replace(positional=positional, output_folder=str(
            tmp / f"graph_{kind}_card"))
        sync()
        t0 = time.perf_counter()
        graph = run_interp_graph(args, params, cfg, rows,
                                 features_to_ablate={l1: src},
                                 target_features={l1: src, l2: dst})
        sync()
        wall = time.perf_counter() - t0
        on_disk = json.loads((tmp / f"graph_{kind}_card" /
                              "ablation_graph.json").read_text())
        keys, _ = graph_values(graph)
        if len(on_disk) != len(graph) or len(keys) != \
                len(src) * (len(src) + len(dst) - 1):
            raise AssertionError(f"(d) {kind}: {len(keys)} edges, "
                                 f"{len(on_disk)} in ablation_graph.json")
        card[kind] = (args, graph, src, dst, code_max)
        out[kind] = {"edges": len(keys), "wall_s": wall,
                     "max_code": code_max}
        log(f"  (d) run_interp_graph {kind} mlp.1 -> mlp.2 ({g.n_fragments} "
            f"fragments x {g.fragment_len} tokens): {GRAPH_FEATS} sources, "
            f"{len(keys)} edges, {wall:.2f} s on the card")
    pick = feats[:INVESTIGATE_FEATS]
    inv = InvestigateArgs(layer=2, layer_loc="mlp",
                          learned_dict_path=str(mlp2_file),
                          feature_indices=pick,
                          output_folder=str(tmp / "investigate"))
    t0 = time.perf_counter()
    recs = investigate_features(inv, params, cfg, rows, decode_token=str)
    wall = time.perf_counter() - t0
    written = sorted(p.name for p in (tmp / "investigate").glob("feature_*"))
    if [r["feature"] for r in recs] != pick or written != sorted(
            f"feature_{f}" for f in pick):
        raise AssertionError(f"(d) investigate {pick}: records "
                             f"{[r['feature'] for r in recs]}, {written}")
    out["investigate"] = {"features": pick, "wall_s": wall}
    log(f"  (d) investigate_features {pick} ({inv.n_fragments} fragments): "
        f"records for exactly those, {wall:.2f} s")
    return out, card


def graph_checks(cpu, cfg, rows: np.ndarray, card: dict) -> dict:
    """(d) card vs CPU, within phase 14 (d)'s bound, on the edges of the
    first GRAPH_CPU_SOURCES sources of each graph ``interp_graphs`` built
    on the card (the CPU's forwards take most of the phase's time
    otherwise). Nothing here is timed."""
    from sparse_coding_tpu_torch.interp.graph import run_interp_graph

    l1, l2 = (1, "mlp"), (2, "mlp")
    out = {}
    for kind, (args, graph, src, dst, code_max) in card.items():
        folder = Path(args.output_folder).with_name(f"graph_{kind}_cpu")
        # the CPU ablates the first GRAPH_CPU_SOURCES sources; every source
        # stays a target, so its edges are the card's from those sources
        ref = run_interp_graph(
            args.replace(output_folder=str(folder)), cpu, cfg, rows,
            features_to_ablate={l1: src[:GRAPH_CPU_SOURCES]},
            target_features={l1: src, l2: dst})
        if len(json.loads((folder / "ablation_graph.json").read_text())) \
                != len(ref):
            raise AssertionError(f"(d) {kind} cpu: ablation_graph.json")
        keys, _ = graph_values(graph)
        ckeys, want = graph_values(ref)
        if not set(ckeys) <= set(keys) or len(ckeys) != \
                GRAPH_CPU_SOURCES * (len(src) + len(dst) - 1):
            raise AssertionError(f"(d) {kind}: the CPU's edges are not the "
                                 "card's from its sources")
        got = torch.tensor([graph[k] for k in ckeys], dtype=torch.float64)
        if not float(want.max()) > 0:
            raise AssertionError(f"(d) {kind}: the ablations moved nothing")
        err = compare(f"(d) {kind} graph card vs CPU", got, want, 0.0,
                      RTOL_EVAL * code_max * math.sqrt(max(args.n_fragments,
                                                           args.fragment_len)))
        out[kind] = {"card_vs_cpu": err, "max_weight": float(want.max())}
        log(f"  (d) {kind} graph card vs CPU ({len(ckeys)} edges of "
            f"{GRAPH_CPU_SOURCES} sources) abs err {err['max_abs_err']:.2e} "
            f"(largest weight {float(want.max()):.3e}, largest code "
            f"{code_max:.3e})")
    return out


def interp_snapshots(params, cfg, rows: np.ndarray, store2: Path,
                     tmp: Path) -> dict:
    """(e) the sweep CLI, zero_l1_baseline tied (3 members), 2 chunks of the
    mlp.2 store with a snapshot a chunk: each tied kernel once a step
    (counts zeroed just before); interpret_across_chunks (the same
    features in both snapshots) and interpret_across_big_sweep over its
    snapshots, plot_n_active_over_time's series and read_transform_scores
    (the interp CLI runs at the phase's end: ``interp_cli``)."""
    from sparse_coding_tpu_torch.config import InterpArgs
    from sparse_coding_tpu_torch.data.chunk_store import ChunkStore
    from sparse_coding_tpu_torch.interp.run import (
        interpret_across_big_sweep,
        interpret_across_chunks,
        read_transform_scores,
    )
    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.plotting.timeseries import (
        plot_autointerp_across_chunks,
        plot_n_active_over_time,
    )

    out = tmp / "interp_sweep"
    rows_per_chunk = int(LM_CHUNK_GB * 2**30 / (LM_D_MLP * 2))  # (13 a)
    steps = SNAP_CHUNKS * rows_per_chunk // BATCH
    args = ["--experiment", "zero_l1_baseline", "--tied_ae", "true",
            "--dataset_folder", str(store2), "--output_folder", str(out),
            "--batch_size", str(BATCH), "--learned_dict_ratio", str(RATIO),
            "--lr", str(LR), "--seed", str(SEED), "--n_chunks",
            str(SNAP_CHUNKS), "--save_every_chunks", "1",
            "--image_metrics_every", "none", "--layer", str(INTERP_LAYER),
            "--layer_loc", "mlp", "--log_every", str(steps // SNAP_CHUNKS),
            "--device", DEV]
    _build.reset_launches()
    sweep_s = sweep_in_process(args, tmp / "interp_obs")
    launches = tied_launches(steps, "(e) zero_l1_baseline sweep")
    snaps = sorted(p.name for p in out.glob("_*"))
    if snaps != [f"_{i}" for i in range(SNAP_CHUNKS)]:
        raise AssertionError(f"(e) snapshots {snaps}")
    icfg = InterpArgs(layer=INTERP_LAYER, layer_loc="mlp",
                      n_fragments=SNAP_FRAGMENTS,
                      n_feats_to_explain=SNAP_FEATS,
                      output_folder=str(tmp / "interp_chunks"))
    t0 = time.perf_counter()
    chunks = interpret_across_chunks(out, icfg, params, cfg, rows, str)
    chunks_s = time.perf_counter() - t0
    members = list(chunks["_0"])
    if list(chunks) != snaps or list(chunks["_1"]) != members or any(
            [r["feature"] for r in chunks["_0"][m]]
            != [r["feature"] for r in chunks["_1"][m]] for m in members):
        raise AssertionError("(e) interpret_across_chunks did not pin the "
                             "same features in both snapshots")
    t0 = time.perf_counter()
    big = interpret_across_big_sweep(out, icfg.replace(output_folder=str(
        tmp / "interp_big")), params, cfg, rows, str)
    big_s = time.perf_counter() - t0
    if len(big) != len(members) or not all(
            len(v) == SNAP_FEATS for v in big.values()):
        raise AssertionError(f"(e) interpret_across_big_sweep {list(big)}")
    series = plot_n_active_over_time(out, ChunkStore(store2), device=DEV)
    if len(series) != len(members) or not all(
            s["snapshots"] == list(range(SNAP_CHUNKS))
            for s in series.values()):
        raise AssertionError(f"(e) n_active series {series}")
    scores = read_transform_scores(tmp / "interp_chunks" / "_1")
    over_time = plot_autointerp_across_chunks(tmp / "interp_chunks")
    if len(scores) != len(members) or len(over_time) != len(members):
        raise AssertionError(f"(e) read_transform_scores {list(scores)}")
    log(f"  (e) sweep CLI zero_l1_baseline tied ({len(members)} members, n="
        f"{RATIO * LM_D_MLP}) over mlp.2: {steps} steps, {SNAP_CHUNKS} "
        f"snapshots in {sweep_s:.2f} s, each tied kernel {steps} launches; "
        f"interpret_across_chunks {chunks_s:.2f} s (same features pinned), "
        f"interpret_across_big_sweep {big_s:.2f} s ({SNAP_FRAGMENTS} "
        f"fragments, {SNAP_FEATS} features); n_active over time "
        f"{[s['n_active'] for s in series.values()]}")
    return {"steps": steps, "launches": launches, "sweep_s": sweep_s,
            "chunks_s": chunks_s, "big_sweep_s": big_s,
            "n_active": series}


@contextlib.contextmanager
def interp_cli(tmp: Path, scored: Path):
    """(e) ``python -m sparse_coding_tpu_torch.interp.run`` on the card
    with tiny-gptneox: ``interpret``, ``chunks`` and ``read_results`` of
    ``scored`` (a folder ``run`` filled: (a)'s) start as three children at
    once when the block opens (they run beside the block's work, which
    must time nothing); the block calls the yielded ``finish``, which
    waits for them and checks what they wrote and printed. Children still
    running when the block exits are killed."""
    import os

    from sparse_coding_tpu_torch.data.tokenize import save_token_dataset
    from sparse_coding_tpu_torch.interp.run import read_scores
    from sparse_coding_tpu_torch.lm.model_config import tiny_test_config
    from sparse_coding_tpu_torch.models import TiedSAE
    from sparse_coding_tpu_torch.utils.artifacts import save_learned_dicts

    tiny = tiny_test_config("gptneox")
    root = tmp / "interp_cli"
    g = torch.Generator().manual_seed(SEED + 15)
    save_token_dataset(np.random.default_rng(SEED + 15).integers(
        0, tiny.vocab_size, (24, 16)).astype(np.int32), root / "toks.npy")

    def tied(n):
        return TiedSAE(dictionary=torch.randn(n, tiny.d_model, generator=g),
                       encoder_bias=torch.full((n,), -0.1))

    save_learned_dicts([(tied(16), {"l1_alpha": 1e-3})], root / "dict.pkl")
    for i in range(2):
        save_learned_dicts([(tied(16), {"l1_alpha": 1e-3})] * 2,
                           root / "sweep" / f"_{i}" / "e_learned_dicts.pkl")
    common = ["--tokens", str(root / "toks.npy"), "--model_name",
              "tiny-gptneox", "--layer", "1", "--n_fragments", "12",
              "--fragment_len", "8", "--n_feats_to_explain", "2",
              "--top_k_fragments", "3", "--n_random_fragments", "2",
              "--batch_size", "4",
              # the CLI's default device is the card
              *([] if DEV == "cuda" else ["--device", DEV])]
    cmd = [sys.executable, "-m", "sparse_coding_tpu_torch.interp.run"]
    env = {k: v for k, v in os.environ.items()
           if k not in ("SPARSE_CODING_FAULT_PLAN", "SPARSE_CODING_CRASH_PLAN")}
    here = Path(__file__).resolve().parent

    def child(*args):
        return subprocess.Popen([*cmd, *args], cwd=here, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)

    t0 = time.perf_counter()
    procs = {"interpret": child("--learned_dict_path", str(root / "dict.pkl"),
                                "--output_folder", str(root / "out"),
                                *common),
             "chunks": child("chunks", "--target", str(root / "sweep"),
                             "--output_folder", str(root / "chunks_out"),
                             *common),
             "read_results": child("read_results", "--output_folder",
                                   str(scored))}

    def finish() -> dict:
        outs = {}
        for name in ("interpret", "chunks"):
            proc = procs[name]
            stdout, stderr = proc.communicate(timeout=300)
            if proc.returncode != 0 or f"interp {name}:" not in stdout:
                raise AssertionError(f"(e) CLI {name}: exit "
                                     f"{proc.returncode}: {stderr[-2000:]}")
            outs[name] = stdout.strip().splitlines()[-1]
        if len(read_scores(root / "out" / "dict_0")) != 2:
            raise AssertionError("(e) CLI interpret: no 2 scores.json")
        stdout, stderr = procs["read_results"].communicate(timeout=300)
        printed = (json.loads(stdout)
                   if procs["read_results"].returncode == 0 else None)
        want = read_scores(scored)
        if printed is None or not want or \
                {int(k): v for k, v in printed.items()} != want:
            raise AssertionError(f"(e) CLI read_results: {stderr[-2000:]}")
        wall = time.perf_counter() - t0
        log(f"  (e) interp CLI on the card (tiny-gptneox): "
            f"{outs['interpret']}; {outs['chunks']}; read_results printed "
            f"{len(printed)} records ({wall:.1f} s from the children's "
            "start, beside the untimed checks)")
        return {"wall_s": wall, **outs}

    try:
        yield finish
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def catalog_close(card: Path, cpu: Path) -> dict:
    """(f) a card-built catalog against a CPU-built one: dead flags equal,
    counts equal but one flip per million codes, mag within
    RTOL_CATALOG_MAG of max|ref|, mmcs within CATALOG_MMCS_TOL, match
    cosines within COS_TOL and their indices equal but at near-ties."""
    from sparse_coding_tpu_torch.catalog.build import CatalogIndex

    got, ref = CatalogIndex.load(card, verify=True), CatalogIndex.load(
        cpu, verify=True)
    if {k: v for k, v in got.meta.items() if k != "files"} != \
            {k: v for k, v in ref.meta.items() if k != "files"}:
        raise AssertionError("(f) index metadata card vs CPU")
    n_rows, flips, codes, ties, mag_err = ref.meta["n_rows"], 0, 0, 0, 0.0
    rows = [torch.from_numpy(ref.rows(i)) for i in range(ref.n_dicts)]
    for i in range(ref.n_dicts):
        if not np.array_equal(got.dead(i), ref.dead(i)):
            raise AssertionError(f"(f) dict {i}: dead flags card vs CPU")
        flips += int(np.abs(np.rint(got.freq(i).astype(np.float64) * n_rows)
                            - np.rint(ref.freq(i).astype(np.float64)
                                      * n_rows)).sum())
        codes += n_rows * rows[i].shape[0]
        scale = max(float(np.abs(ref.mag(i)).max()), 1e-30)
        mag_err = max(mag_err, float(np.abs(got.mag(i) - ref.mag(i)).max())
                      / scale)
        cos = np.abs(got._arr(i, "match_cos") - ref._arr(i, "match_cos"))
        if not cos.max() <= COS_TOL:
            raise AssertionError(f"(f) dict {i}: match cosines {cos.max()}")
        gd, gf = got._arr(i, "match_dict"), got._arr(i, "match_feat")
        rd, rf = ref._arr(i, "match_dict"), ref._arr(i, "match_feat")
        for f in np.nonzero((gd != rd) | (gf != rf))[0]:
            a = rows[i][f]
            if not abs(float(a @ rows[gd[f]][gf[f]])
                       - float(a @ rows[rd[f]][rf[f]])) <= COS_TOL:
                raise AssertionError(f"(f) dict {i} feature {f}: partner "
                                     f"({gd[f]}, {gf[f]}) vs ({rd[f]}, "
                                     f"{rf[f]}) is no near-tie")
            ties += 1
    if not flips <= FLIPS_PER_CODE * codes:
        raise AssertionError(f"(f) {flips} count flips in {codes} codes")
    if not mag_err <= RTOL_CATALOG_MAG:
        raise AssertionError(f"(f) mag rel err {mag_err:.3e}")
    mmcs_err = float(np.abs(got.mmcs_matrix() - ref.mmcs_matrix()).max())
    if not mmcs_err <= CATALOG_MMCS_TOL:
        raise AssertionError(f"(f) mmcs card vs CPU {mmcs_err:.3e}")
    return {"count_flips": flips, "codes": codes, "mag_rel_err": mag_err,
            "mmcs_err": mmcs_err, "match_near_ties": ties}


def interp_catalog(dict_file: Path, store2: Path, tmp: Path) -> dict:
    """(f) build_catalog over the 16 tied mlp.2 dicts and the whole mlp.2
    store on the card, twice (timed, byte-identical), the index loaded
    with verify and one live feature's stats."""
    from sparse_coding_tpu_torch.catalog.build import (
        CatalogIndex,
        build_catalog,
    )

    walls = []
    for name in ("catalog_a", "catalog_b"):
        sync()
        t0 = time.perf_counter()
        meta = build_catalog(dict_file, store2, tmp / name,
                             experiment="phase15", device=DEV)
        walls.append(time.perf_counter() - t0)
    if digests(tmp / "catalog_a") != digests(tmp / "catalog_b"):
        raise AssertionError("(f) two builds differ")
    index = CatalogIndex.load(tmp / "catalog_a", verify=True)
    live = int(np.argmax(index.freq(0)))
    stats = index.feature_stats(0, live)
    if stats["dead"] or not stats["freq"] > 0 or stats["match_dict"] < 0:
        raise AssertionError(f"(f) feature_stats(0, {live}) {stats}")
    n_dead = [d["n_dead"] for d in meta["dicts"]]
    log(f"  (f) build_catalog over {len(n_dead)} tied mlp.2 dicts and "
        f"{meta['n_rows']} rows: {walls[0]:.2f} s and {walls[1]:.2f} s, "
        f"byte-identical; dead per dict {n_dead}; feature_stats(0, {live}) "
        f"freq {stats['freq']:.4f}, match ({stats['match_dict']}, "
        f"{stats['match_feat']}) cos {stats['match_cos']:.4f}")
    return {"build_s": walls, "n_rows": meta["n_rows"], "n_dead": n_dead,
            "stats": stats}


def catalog_checks(dicts: list, store2: Path, tmp: Path) -> dict:
    """(f) card vs CPU on CATALOG_CHECK_ROWS rows and CATALOG_CHECK_DICTS
    of ``dicts`` (the 16 tied mlp.2 dicts, loaded); neighbor_topk and
    union_vote over the 16, card vs CPU. Nothing here is timed."""
    from sparse_coding_tpu_torch.catalog.build import build_catalog
    from sparse_coding_tpu_torch.catalog.query import (
        neighbor_topk,
        union_vote,
        unpack_neighbors,
    )
    from sparse_coding_tpu_torch.data.chunk_store import ChunkStore, ChunkWriter
    from sparse_coding_tpu_torch.utils.artifacts import save_learned_dicts
    from sparse_coding_tpu_torch.utils.trees import stack_trees

    store = ChunkStore(store2)
    chunk = store.load_chunk(0)[:CATALOG_CHECK_ROWS]
    small = tmp / "catalog_rows"
    w = ChunkWriter(small, chunk.shape[1],
                    chunk_size_gb=chunk.nbytes / 2 / 2**30, dtype="bfloat16")
    w.add(chunk)
    w.finalize()
    few = tmp / "catalog_few.pkl"
    save_learned_dicts(dicts[:CATALOG_CHECK_DICTS], few)
    for side, dev in (("card", DEV), ("cpu", "cpu")):
        build_catalog(few, small, tmp / f"catalog_{side}", device=dev)
    side = catalog_close(tmp / "catalog_card", tmp / "catalog_cpu")
    x = torch.as_tensor(chunk[:QUERY_ROWS], dtype=torch.float32)
    q = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    ld0 = dicts[0][0]
    card_v, card_i = unpack_neighbors(neighbor_topk(ld0.to(DEV), q.to(DEV),
                                                    QUERY_K))
    cpu_v, cpu_i = unpack_neighbors(neighbor_topk(ld0, q, QUERY_K))
    if not np.abs(card_v - cpu_v).max() <= COS_TOL:
        raise AssertionError("(f) neighbor_topk values card vs CPU")
    sims = q @ ld0.get_learned_dict().T
    moved = np.nonzero(card_i != cpu_i)
    for r, c in zip(*moved):  # a different neighbor must be a near-tie
        if not abs(float(sims[r, card_i[r, c]] - sims[r, cpu_i[r, c]])) \
                <= COS_TOL:
            raise AssertionError(f"(f) neighbor_topk row {r}: {card_i[r]} "
                                 f"vs {cpu_i[r]}")
    stack = stack_trees([ld for ld, _ in dicts])
    card_votes = union_vote(stack.to(DEV), x.to(DEV)).cpu()
    cpu_votes = union_vote(stack, x)
    vote_flips = int((card_votes - cpu_votes).abs().sum())
    vote_codes = len(dicts) * card_votes.numel()
    if not vote_flips <= FLIPS_PER_CODE * vote_codes:
        raise AssertionError(f"(f) union_vote: {vote_flips} flips")
    log(f"  (f) catalog card vs CPU ({CATALOG_CHECK_ROWS} rows, "
        f"{CATALOG_CHECK_DICTS} dicts): {side['count_flips']} count flips, "
        f"mag rel err {side['mag_rel_err']:.2e}, mmcs err "
        f"{side['mmcs_err']:.2e}, {side['match_near_ties']} match near-ties; "
        f"neighbor_topk (k={QUERY_K}, {QUERY_ROWS} rows) {len(moved[0])} "
        f"near-tie swaps; union_vote over {len(dicts)} members "
        f"{vote_flips} flips")
    return {"card_vs_cpu": side, "neighbor_swaps": int(len(moved[0])),
            "vote_flips": vote_flips}


def interp_plotting(tied_file: Path, untied_file: Path, store2: Path) -> dict:
    """(g) generate_scores and n_active_features over phase 13's two
    artifacts on PLOT_ROWS mlp.2 rows on the card (timed); sweep_grid on
    the scores. No figure is drawn."""
    from sparse_coding_tpu_torch.data.chunk_store import ChunkStore
    from sparse_coding_tpu_torch.plotting.frontiers import generate_scores
    from sparse_coding_tpu_torch.plotting.sweeps import (
        n_active_features,
        sweep_grid,
    )

    x = ChunkStore(store2).load_chunk(0)[:PLOT_ROWS]
    sync()
    t0 = time.perf_counter()
    scores = generate_scores([tied_file, untied_file], x, device=DEV)
    active = n_active_features([tied_file, untied_file], x, device=DEV)
    wall = time.perf_counter() - t0
    xs, ys, grid = sweep_grid(scores, y_key="dict_ratio")  # basic_l1_sweep's
    if grid.shape != (len(ys), len(xs)) or not np.isfinite(grid).any():
        raise AssertionError(f"(g) sweep_grid {grid.shape}")
    log(f"  (g) generate_scores + n_active_features over {len(scores)} dicts "
        f"x {PLOT_ROWS} rows: {wall:.2f} s on the card; sweep_grid "
        f"{grid.shape}")
    return {"wall_s": wall, "dicts": len(scores),
            "n_active": [a["n_active"] for a in active],
            "grid": list(grid.shape)}


def plotting_checks(tied: list, untied_file: Path, store2: Path,
                    tmp: Path) -> dict:
    """(g) card vs CPU over member 0 of phase 13's two artifacts (``tied``
    is the tied one, loaded): FVU and L0 within RTOL_EVAL of max|ref|,
    counts equal. Nothing here is timed."""
    from sparse_coding_tpu_torch.data.chunk_store import ChunkStore
    from sparse_coding_tpu_torch.plotting.frontiers import generate_scores
    from sparse_coding_tpu_torch.plotting.sweeps import n_active_features
    from sparse_coding_tpu_torch.utils.artifacts import (
        load_learned_dicts,
        save_learned_dicts,
    )

    x = ChunkStore(store2).load_chunk(0)[:PLOT_ROWS]
    firsts = [tmp / "plot_tied.pkl", tmp / "plot_untied.pkl"]
    save_learned_dicts(tied[:1], firsts[0])
    save_learned_dicts(load_learned_dicts(untied_file)[:1], firsts[1])
    side = {name: (generate_scores(firsts, x, device=dev),
                   n_active_features(firsts, x, device=dev))
            for name, dev in (("card", DEV), ("cpu", "cpu"))}
    err = compare("(g) generate_scores card vs CPU",
                  torch.tensor([[s["fvu"], s["l0"]] for s in side["card"][0]]),
                  torch.tensor([[s["fvu"], s["l0"]] for s in side["cpu"][0]]),
                  RTOL_EVAL)
    if side["card"][1] != side["cpu"][1]:
        raise AssertionError(f"(g) n_active card {side['card'][1]} vs CPU "
                             f"{side['cpu'][1]}")
    log(f"  (g) card vs CPU (2 dicts) rel err {err['max_rel_err']:.2e}, "
        f"n_active {[a['n_active'] for a in side['cpu'][1]]} equal")
    return {"card_vs_cpu": err}


def interp_phase(tmp: Path, lm: dict) -> dict:
    """Phase 15: (a) the fragment pass and run at InterpArgs' defaults,
    (b) card vs CPU, (c) scan_batches, (d) the graph and investigate
    drivers, (e) the snapshot drivers and the CLI, (f) the catalog, (g)
    the plotting data — on phase 13's LM, stores and dicts. The timed
    steps run first ((a), (d), (e), (f)'s builds, (g)); then the interp
    CLI's children start, and only untimed checks run beside them ((b),
    (c), the card-vs-CPU sides of (d), (f) and (g), the query ops), so
    that no timed step shares the card or the host with them."""
    from sparse_coding_tpu_torch.data.tokenize import (
        load_token_dataset,
        save_token_dataset,
    )
    from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts

    t0 = time.perf_counter()
    params, cfg, store = lm["params"], lm["cfg"], lm["store"]
    dict_file = lm["tied_dicts"]
    untied_file = tmp / "lm_untied" / "epoch_0" / "learned_dicts.pkl"
    tied = load_learned_dicts(dict_file)
    ld = tied[0][0].to(DEV)
    save_token_dataset(np.random.default_rng(SEED + 15).integers(
        0, cfg.vocab_size, (INTERP_ROWS, INTERP_CTX)).astype(np.int32),
        tmp / "interp_tokens.npy", {"rows": INTERP_ROWS, "seed": SEED + 15})
    rows = load_token_dataset(tmp / "interp_tokens.npy")
    report = {}
    report["fragments"], frags, fa, feats = interp_fragment_pass(
        params, cfg, ld, rows, tmp)
    report["graphs"], graphs = interp_graphs(
        params, cfg, rows,
        tmp / "eval_mlp1_out" / "epoch_0" / "learned_dicts.pkl",
        dict_file, feats, tmp)
    report["snapshots"] = interp_snapshots(params, cfg, rows,
                                           store / "mlp.2", tmp)
    torch.cuda.empty_cache()
    report["catalog"] = interp_catalog(dict_file, store / "mlp.2", tmp)
    torch.cuda.empty_cache()
    report["plotting"] = interp_plotting(dict_file, untied_file,
                                         store / "mlp.2")
    with interp_cli(tmp, tmp / "interp_a") as finish_cli:
        cpu = lm_params_to(params, "cpu")
        report["card_vs_cpu"] = interp_card_vs_cpu(params, cpu, cfg, ld,
                                                   rows, feats, tmp)
        report["scan"] = interp_scan(params, cfg, ld, frags, fa)
        for kind, side in graph_checks(cpu, cfg, rows, graphs).items():
            report["graphs"][kind].update(side)
        del fa, cpu, graphs
        report["plotting"].update(plotting_checks(tied, untied_file,
                                                  store / "mlp.2", tmp))
        report["catalog"].update(catalog_checks(tied, store / "mlp.2", tmp))
        report["snapshots"]["cli"] = finish_cli()
    report["wall_s"] = time.perf_counter() - t0
    log(f"  phase 15: {report['wall_s']:.1f} s")
    return report


# --- main --------------------------------------------------------------------

# -- phase 12: the model zoo, the metrics and the reference interop ----------

RECOVERY_STEPS, RECOVERY_L1S = 2000, (3e-4, 1e-3, 3e-3)
# SparseMixDataset store of phase 12 (a): d=512, its ground truth and noise
MIX_GT, MIX_NONZERO, MIX_DECAY, MIX_NOISE, MIX_CHUNKS = 1024, 32, 0.999, \
    0.01, 3
GROUP_EXPERIMENTS = ("topk", "residual_denoising", "centered_l1_range",
                     "reverse_l1_range", "positive_l1_range",
                     "semilinear_l1_range", "rica")
GROUP_CHUNKS, GROUP_SIDE_STEPS = 2, 3
# LISTA's whole weights, card vs CPU after GROUP_SIDE_STEPS steps, as
# ‖Δ‖/‖W‖. Phase 6's REL_FRO_PATH does not hold: after the first step
# 3-105 of its 6.3M elements went the other way and the rest already
# read 5.7e-5-3.0e-4 (many gradients lie near Adam's eps, where the
# update follows their rounding); by the second step the shrinkage flips
# reach over half the features. scripts/lista_card_vs_cpu.py, seeds 0-7,
# on an H100 80GB HBM3 at 700 W: 3.40e-4 to 6.25e-4, first-step flips 0-7.
REL_FRO_LISTA = 2e-3
# reference round trip: the loaded dict's encode of one batch
RTOL_INTEROP = 1e-6
RTOL_MOMENTS = 1e-4


def recovery_gate() -> dict:
    """(a) the JAX package's recovery gate (tests/test_synthetic_recovery.py
    test_dictionary_recovery_gate) on the card: d=64, 96 true features,
    192-atom tied dicts at three L1 values, batch 512, 2000 steps, lr
    3e-3, through Ensemble's default use_fused — the tied kernels."""
    from sparse_coding_tpu_torch.data.synthetic import RandomDatasetGenerator
    from sparse_coding_tpu_torch.ensemble import Ensemble
    from sparse_coding_tpu_torch.metrics.core import (
        fraction_variance_unexplained,
        representedness,
    )
    from sparse_coding_tpu_torch.models.sae import FunctionalTiedSAE
    from sparse_coding_tpu_torch.ops import _build

    d, n_true = 64, 96
    g = torch.Generator(DEV).manual_seed(SEED)
    gen = RandomDatasetGenerator.create(g, d, n_true, 5, 0.99)
    gi = torch.Generator().manual_seed(SEED)
    members = [FunctionalTiedSAE.init(gi, d, 2 * n_true, l1_alpha=l1)
               for l1 in RECOVERY_L1S]
    ens = Ensemble(members, FunctionalTiedSAE, lr=3e-3, device=DEV)
    _build.reset_launches()
    sync()
    t0 = time.perf_counter()
    for _ in range(RECOVERY_STEPS):
        ens.step_batch(gen.batch(g, 512))
    sync()
    wall = time.perf_counter() - t0
    launches = {k: _build.LAUNCHES[k] for k in TIED_KERNELS}
    if ens.path_resolved != {("train_step_tiled", "default"): 1} or any(
            v != RECOVERY_STEPS for v in launches.values()):
        raise AssertionError(f"(a) recovery: path {ens.path_resolved}, "
                             f"launches {launches}")
    dicts = ens.to_learned_dicts()
    eval_batch = gen.batch(g, 2048)
    rep_ = [float(representedness(gen.feats, ld.to(DEV)).mean())
            for ld in dicts]
    fvus = [float(fraction_variance_unexplained(ld.to(DEV), eval_batch))
            for ld in dicts]
    if not (max(rep_) > 0.9 and min(fvus) < 0.15):
        raise AssertionError(f"(a) recovery gate: representedness {rep_}, "
                             f"FVU {fvus}")
    log(f"  (a) recovery gate on train_step_tiled ({RECOVERY_STEPS} launches "
        f"of each tied kernel, {wall:.1f} s): representedness "
        f"{[round(r, 4) for r in rep_]} (> 0.9), FVU "
        f"{[round(f, 4) for f in fvus]} (< 0.15)")
    return {"wall_s": wall, "launches": launches,
            "path_resolved": {f"{k[0]}:{k[1]}": v
                              for k, v in ens.path_resolved.items()},
            "representedness": rep_, "fvu": fvus, "dicts": dicts}


def write_mix_store(folder: Path):
    """A SparseMixDataset store at d=512 (correlated codes over MIX_GT
    true features plus noise), bfloat16 on disk; returns its generator."""
    from sparse_coding_tpu_torch.data.chunk_store import ChunkWriter
    from sparse_coding_tpu_torch.data.synthetic import SparseMixDataset

    g = torch.Generator(DEV).manual_seed(SEED + 12)
    gen = SparseMixDataset.create(g, D, MIX_GT, MIX_NONZERO, MIX_DECAY,
                                  MIX_NOISE)
    w = ChunkWriter(folder, D, chunk_size_gb=ROWS_PER_CHUNK * D * 2 / 2**30,
                    dtype="bfloat16")
    n_rows = MIX_CHUNKS * ROWS_PER_CHUNK
    for lo in range(0, n_rows, 8192):
        w.add(gen.batch(g, min(8192, n_rows - lo)))
    w.finalize({"synthetic": "SparseMixDataset"})
    return gen


def mix_sweep_and_metrics(tmp: Path) -> dict:
    """(a) basic_l1_sweep at the canonical shape over a SparseMixDataset
    store, the metrics against its ground truth, and the streaming scans
    over the store on the card against the same scans on the CPU."""
    from sparse_coding_tpu_torch.data.chunk_store import ChunkStore
    from sparse_coding_tpu_torch.metrics.core import (
        calc_moments_streaming,
        hungarian_mcs,
        mmcs_to_fixed,
        n_ever_active,
        representedness,
    )
    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.train.basic_sweep import basic_l1_sweep

    store = tmp / "mix_store"
    gen = write_mix_store(store)
    steps = MIX_CHUNKS * ROWS_PER_CHUNK // BATCH
    l1_values = [float(v) for v in np.logspace(-4, -2, N_MEMBERS)]
    _build.reset_launches()
    sync()
    t0 = time.perf_counter()
    dicts = basic_l1_sweep(store, tmp / "mix_out", l1_values,
                           dict_ratio=RATIO, batch_size=BATCH, lr=LR,
                           n_epochs=1, seed=SEED, device=DEV)
    sync()
    wall = time.perf_counter() - t0
    launches = {k: _build.LAUNCHES[k] for k in TIED_KERNELS}
    if any(v != steps for v in launches.values()):
        raise AssertionError(f"(a) mix sweep launches {launches}, want "
                             f"{steps} each")
    truth = gen.feats
    metrics = []
    for ld, _ in dicts:
        ld = ld.to(DEV)
        metrics.append({
            "mmcs_to_fixed": float(mmcs_to_fixed(ld, truth)),
            "representedness": float(representedness(truth, ld).mean())})
    best = max(range(N_MEMBERS), key=lambda i: metrics[i]["representedness"])
    # the assignment runs on the host (scipy), a second or so a member:
    # every eighth member and the best
    for i in sorted({*range(0, N_MEMBERS, 8), best}):
        metrics[i]["hungarian_mcs"] = float(hungarian_mcs(
            truth, dicts[i][0].get_learned_dict().to(DEV)).mean())
    for m in metrics:
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"(a) non-finite metrics {m}")
    probe = dicts[N_MEMBERS // 2][0]
    card_store, cpu_store = ChunkStore(store), ChunkStore(store)
    timed = {}
    for side, ld, st in (("card", probe.to(DEV), card_store),
                         ("cpu", probe.to("cpu"), cpu_store)):
        sync()
        t0 = time.perf_counter()
        n_active = n_ever_active(ld, st, batch_size=BATCH)
        sync()
        t1 = time.perf_counter()
        moments = [t.cpu() for t in calc_moments_streaming(
            ld, st, batch_size=BATCH)]
        sync()
        timed[side] = {"n_ever_active": n_active, "moments": moments,
                       "n_ever_active_s": t1 - t0,
                       "moments_s": time.perf_counter() - t1}
    if timed["card"]["n_ever_active"] != timed["cpu"]["n_ever_active"]:
        raise AssertionError(f"(a) n_ever_active card "
                             f"{timed['card']['n_ever_active']} vs CPU "
                             f"{timed['cpu']['n_ever_active']}")
    names = ("times_active", "mean", "var", "skew", "kurtosis", "m4")
    moment_err = {}
    for name, a, b in zip(names, timed["card"]["moments"],
                          timed["cpu"]["moments"]):
        moment_err[name] = compare(f"moments {name}", a, b, RTOL_MOMENTS)
    log(f"  (a) SparseMixDataset store ({MIX_CHUNKS} chunks of "
        f"{ROWS_PER_CHUNK} rows, {MIX_GT} true features): basic_l1_sweep "
        f"{N_MEMBERS} members, {steps} steps on train_step_tiled "
        f"({launches}) in {wall:.1f} s; best member {best}: mmcs_to_fixed "
        f"{metrics[best]['mmcs_to_fixed']:.4f}, representedness "
        f"{metrics[best]['representedness']:.4f}, hungarian_mcs "
        f"{metrics[best]['hungarian_mcs']:.4f}; member {N_MEMBERS // 2}: "
        f"n_ever_active {timed['card']['n_ever_active']} (card "
        f"{timed['card']['n_ever_active_s']:.2f} s, CPU "
        f"{timed['cpu']['n_ever_active_s']:.2f} s, equal), "
        f"calc_moments_streaming card {timed['card']['moments_s']:.2f} s, "
        f"CPU {timed['cpu']['moments_s']:.2f} s, within rtol {RTOL_MOMENTS}")
    return {"wall_s": wall, "launches": launches, "steps": steps,
            "metrics": metrics, "best_member": best,
            "generator": {"activation_dim": D, "n_sparse_components": MIX_GT,
                          "feature_num_nonzero": MIX_NONZERO,
                          "feature_prob_decay": MIX_DECAY,
                          "noise_magnitude_scale": MIX_NOISE,
                          "rows": MIX_CHUNKS * ROWS_PER_CHUNK},
            "streaming": {side: {k: v for k, v in t.items()
                                 if k != "moments"}
                          for side, t in timed.items()},
            "moment_err": moment_err, "dicts": dicts}


def group_args(experiment: str, store: Path, out: Path, *extra) -> list:
    args = sweep_args(store, out, "--n_chunks", str(GROUP_CHUNKS), *extra)
    args[args.index("tied_vs_not")] = experiment
    return args


def small_grid(experiment: str) -> dict:
    """The first two points of each experiment's default grid, at full
    width: the card-against-CPU steps."""
    if experiment == "topk":
        return {"ks": (4, 8)}
    if experiment in ("residual_denoising", "rica"):
        grid = list(np.logspace(-4, -2, 8))[:2]
    else:
        from sparse_coding_tpu_torch.train.experiments import DEFAULT_L1_RANGE

        grid = DEFAULT_L1_RANGE[:2]
    return {"sparsity_range" if experiment == "rica" else "l1_range": grid}


def lista_masks(ens, batch: torch.Tensor) -> torch.Tensor:
    """[members, layers, rows, features] bool, on the CPU: which codes
    pass a LISTA bucket's shrinkage (|r| > θ) at each unrolled layer, on
    the bucket's own device and parameters."""
    from sparse_coding_tpu_torch.models.learned_dict import normalize_rows
    from sparse_coding_tpu_torch.models.lista import _lista_step

    p = ens.state.params
    out = []
    with torch.no_grad():
        for m in range(ens.n_members):
            dictionary = normalize_rows(p["decoder"][m])
            y = x = batch @ dictionary.T
            layers = []
            for i in range(p["encoder_layers/W"].shape[1]):
                layer = {k: p[f"encoder_layers/{k}"][m, i]
                         for k in ("W", "theta", "rho")}
                r = y + (batch - y @ dictionary) @ layer["W"].T
                layers.append((r.abs() > layer["theta"]).cpu())
                y, x = _lista_step(layer, y, batch, x, dictionary)
            out.append(torch.stack(layers))
    return torch.stack(out)


# the feature axis of each LISTA leaf that has one (rho has none)
LISTA_FEATURE_AXIS = {"decoder": 1, "encoder_layers/W": 2,
                      "encoder_layers/theta": 2}


def lista_side_check(name: str, ge, ce, g_masks, c_masks, g_first,
                     c_first) -> dict:
    """A LISTA bucket, card against CPU. The shrinkage flips are counted
    from each side's masks before each step, at every layer: a code
    within rounding of its threshold θ passes on one side only. The first
    step's (both sides from the same parameters: rounding alone) are
    capped at FLIPS_PER_CODE. After the first step, the elements whose
    Adam update went the other way (2·lr apart: a gradient within
    rounding of 0) are counted, and the rest read. The whole weights
    after the last step, every leaf's elements together, are held within
    REL_FRO_LISTA; the features with no flip at any step are read apart
    (the gap does not stay on the flipped features: the steps that went
    the other way reach every feature through the shared dictionary)."""
    flipped = [g != c for g, c in zip(g_masks, c_masks)]
    by_step = [int(f.sum()) for f in flipped]
    # [members, features]: a flip at any step, layer or row
    keep = ~torch.stack([f.any(dim=2).any(dim=1) for f in flipped]).any(0)
    kept, every, opposite, first_rest = {}, {}, {}, {}
    for k, v in ge.state.params.items():
        a, b = v.detach().cpu(), ce.state.params[k].detach().cpu()
        every[k] = (a.reshape(-1), b.reshape(-1))
        axis = LISTA_FEATURE_AXIS.get(k)
        if axis is not None:
            a, b = a.movedim(axis, 1)[keep], b.movedim(axis, 1)[keep]
        kept[k] = (a.reshape(-1), b.reshape(-1))
        other = (g_first[k] - c_first[k]).abs() > LR
        opposite[k] = int(other.sum())
        first_rest[k] = rel_fro(g_first[k][~other], c_first[k][~other])
    together = lambda pairs: rel_fro(torch.cat([a for a, _ in pairs]),
                                     torch.cat([b for _, b in pairs]))
    whole = together(every.values())
    allowed = max(1, int(FLIPS_PER_CODE * flipped[0].numel()))
    return {"bucket": name, "flips_by_step": by_step,
            "codes": flipped[0].numel(), "flips_allowed": allowed,
            "flipped_features": int((~keep).sum()),
            "features": int(keep.numel()),
            "first_step_opposite": opposite,
            "first_step_rest": first_rest,
            "rel_fro": whole, "rel_fro_bound": REL_FRO_LISTA,
            "rel_fro_leaves": {k: rel_fro(a, b)
                               for k, (a, b) in every.items()},
            "rel_fro_unflipped": together(kept.values()),
            "failed": by_step[0] > allowed or not whole <= REL_FRO_LISTA}


def card_vs_cpu_steps(experiment: str, store: Path, batches,
                      seed: int = SEED) -> dict:
    """The experiment's entries from one init on the card and on the CPU,
    GROUP_SIDE_STEPS steps on the same batches: per-step losses within
    RTOL_PATH_LOSS; each bucket's whole weights (every leaf's elements
    together) within REL_FRO_PATH of the CPU's, a LISTA bucket's within
    REL_FRO_LISTA, its flips counted (``lista_side_check``). The centered
    experiment fits its whitening on the card and hands it to the CPU."""
    from sparse_coding_tpu_torch.config import EnsembleArgs
    from sparse_coding_tpu_torch.train.experiments import EXPERIMENTS

    cfg = EnsembleArgs(dataset_folder=str(store), batch_size=BATCH, lr=LR,
                       learned_dict_ratio=RATIO, seed=seed)
    is_lista = lambda name: name.startswith("lista_denoising_sae")
    sides = {}
    grid = small_grid(experiment)
    for dev in (DEV, "cpu"):
        entries = EXPERIMENTS[experiment](cfg, None, device=dev, **grid)
        if experiment == "centered_l1_range" and "centering" not in grid:
            # the CPU takes the card's whitening (fitted on the card, as
            # the CLI does): 1/√λ would carry two fits' rounding into
            # every member's buffers
            b = entries[0][0].state.buffers
            grid["centering"] = tuple(
                b[k][0].cpu().numpy()
                for k in ("center_trans", "center_rot", "center_scale"))
        buckets = [(sub or name, e) for ent, _, name in entries
                   for sub, e in ent.buckets()]
        losses = {name: [] for name, _ in buckets}
        masks = {name: [] for name, _ in buckets if is_lista(name)}
        first = {}
        for b in batches:
            b = b.to(dev)
            for name, e in buckets:
                if name in masks:
                    masks[name].append(lista_masks(e, b))
                losses[name].append(e.step_batch(b).losses["loss"].cpu())
                if name in masks and name not in first:
                    first[name] = {k: v.detach().cpu().clone()
                                   for k, v in e.state.params.items()}
        sides[dev] = (buckets, losses, masks, first)
    (gb, gl, gm, gf), (cb, cl, cm, cf) = sides[DEV], sides["cpu"]
    worst_loss, worst_fro = 0.0, None
    leaves, lista = {}, []
    for (name, ge), (_, ce) in zip(gb, cb):
        if ge.fused_path is not None:
            raise AssertionError(f"(b) {experiment}/{name} on "
                                 f"{ge.fused_path}: these families train on "
                                 "autodiff")
        for a, b in zip(gl[name], cl[name]):
            err = float((a - b).abs().max() / b.abs().max())
            worst_loss = max(worst_loss, err)
        for k, v in ge.state.params.items():
            leaves[f"{name}/{k}"] = rel_fro(v.cpu(), ce.state.params[k])
        if is_lista(name):
            lista.append(lista_side_check(name, ge, ce, gm[name], cm[name],
                                          gf[name], cf[name]))
            continue
        flat = lambda e: torch.cat([v.detach().cpu().reshape(-1)
                                    for v in e.state.params.values()])
        worst_fro = max(worst_fro or 0.0, rel_fro(flat(ge), flat(ce)))
    failed = (worst_loss > RTOL_PATH_LOSS
              or (worst_fro is not None and not worst_fro <= REL_FRO_PATH)
              or any(c["failed"] for c in lista))
    return {"loss_rel_err": worst_loss, "rel_fro": worst_fro,
            "rel_fro_bound": REL_FRO_PATH, "rel_fro_leaves": leaves,
            "lista": lista, "buckets": [name for name, _ in gb],
            "failed": failed}


def group_experiments(store: Path, tmp: Path) -> dict:
    """(b) the seven group experiments through the CLI over 2 chunks of
    phase 8's store: artifacts that load, finite member losses, acts/s
    over the second chunk; and card against CPU for three steps."""
    from sparse_coding_tpu_torch.data.chunk_store import ChunkStore
    from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts

    chunk = torch.as_tensor(ChunkStore(store).load_chunk(0))
    batches = [chunk[i * BATCH:(i + 1) * BATCH].float()
               for i in range(GROUP_SIDE_STEPS)]
    rep = {}
    for exp in GROUP_EXPERIMENTS:
        out = tmp / f"group_{exp}"
        wall = sweep_in_process(group_args(exp, store, out),
                                tmp / f"obs_{exp}")
        dicts = load_learned_dicts(out / f"_{GROUP_CHUNKS - 1}"
                                   / f"{exp}_learned_dicts.pkl")
        losses = [v for r in read_metrics(out / "metrics.jsonl")
                  for k, v in r.items() if k.endswith("/loss")]
        if not dicts or not losses or not all(
                math.isfinite(v) for v in losses):
            raise AssertionError(f"(b) {exp}: {len(dicts)} dicts, losses "
                                 f"{losses[:8]}")
        chunks = [e for e in read_events(tmp / f"obs_{exp}")
                  if e.get("span") == "sweep.chunk"]
        acts = chunks[-1]["rows"] / chunks[-1]["train_s"]
        side = card_vs_cpu_steps(exp, store, batches)
        rep[exp] = {"wall_s": wall, "n_dicts": len(dicts),
                    "classes": sorted({type(d).__name__ for d, _ in dicts}),
                    "acts_per_s_chunk2": acts, "out": str(out), **side}
        log(f"  (b) {exp}: {len(dicts)} dicts "
            f"({', '.join(rep[exp]['classes'])}), {wall:.1f} s, "
            f"{acts:.0f} acts/s over chunk 2; card vs CPU "
            f"{GROUP_SIDE_STEPS} steps: losses {side['loss_rel_err']:.1e}"
            + (f", weights {side['rel_fro']:.1e} (bound "
               f"{side['rel_fro_bound']})" if side["rel_fro"] is not None
               else "")
            + "".join(f"; {c['bucket']}: weights {c['rel_fro']:.2e} "
                      f"(bound {c['rel_fro_bound']}), {c['flips_by_step']} "
                      f"shrinkage flips by step of {c['codes']} codes a step"
                      f" (cap {c['flips_allowed']} on the first), "
                      f"{sum(c['first_step_opposite'].values())} elements "
                      "stepped the other way at the first"
                      for c in side["lista"]))
    bad = {exp: r for exp, r in rep.items() if r["failed"]}
    if bad:
        raise AssertionError(f"(b) card vs CPU beyond RTOL_PATH_LOSS or the "
                             f"weights' bound: {bad}")
    return rep


def topk_kill_and_resume(store: Path, tmp: Path, ref: Path) -> dict:
    """(c) topk (six buckets) killed mid-swap of the second chunk's
    checkpoint set, then resumed: dicts and ckpt/ bitwise (b)'s run."""
    out = tmp / "group_topk_killed"
    args = group_args("topk", store, out)
    killed = sweep_subprocess(args, tmp / "obs_topk_killed",
                              crash_plan="ckpt.swap:nth=2")
    if killed.returncode != -9 or "SIGKILL at site 'ckpt.swap'" not in \
            killed.stderr:
        raise AssertionError(f"(c) topk kill: rc {killed.returncode}\n"
                             f"{killed.stderr[-3000:]}")
    t0 = time.perf_counter()
    sweep_in_process(args + ["--resume", "true"], tmp / "obs_topk_resume")
    resume_s = time.perf_counter() - t0
    names = sorted(p.name for p in (ref / "ckpt").iterdir())
    if [n for n in names if n.endswith(".tensors")] != [
            f"topk_{j}.tensors" for j in range(6)]:
        raise AssertionError(f"(c) checkpoint files {names}")
    if sorted(p.name for p in (out / "ckpt").iterdir()) != names:
        raise AssertionError("(c) the resumed run's ckpt/ holds other files")
    for name in names:
        if (out / "ckpt" / name).read_bytes() != \
                (ref / "ckpt" / name).read_bytes():
            raise AssertionError(f"(c) ckpt/{name} differs")
    for name in ("topk_learned_dicts.pkl", "topk_eval.json"):
        f = Path(f"_{GROUP_CHUNKS - 1}") / name
        if (out / f).read_bytes() != (ref / f).read_bytes():
            raise AssertionError(f"(c) {f} differs")
    log(f"  (c) topk killed at ckpt.swap hit 2, resumed in {resume_s:.1f} s: "
        f"six buckets' dicts and ckpt/ bitwise the uninterrupted run's")
    return {"resume_s": resume_s, "files": names}


def reference_round_trip(tmp: Path, pairs) -> dict:
    """(d) export_reference_learned_dicts of each exportable dict, then
    load_reference_learned_dicts on the card: equal fields, encode within
    RTOL_INTEROP; the classes the reference cannot hold raise."""
    from sparse_coding_tpu_torch.utils.ref_interop import (
        export_reference_learned_dicts,
        load_reference_learned_dicts,
    )

    exportable = ("UntiedSAE", "TiedSAE", "TiedCenteredSAE", "ReverseSAE",
                  "TopKLearnedDict")
    g = torch.Generator().manual_seed(12)
    ok = [(ld, h) for ld, h in pairs if type(ld).__name__ in exportable]
    refused = []
    for ld, h in pairs:
        if type(ld).__name__ not in exportable:
            try:
                export_reference_learned_dicts([(ld, h)], tmp / "no.pt")
            except NotImplementedError:
                refused.append(type(ld).__name__)
                continue
            raise AssertionError(f"(d) {type(ld).__name__} exported")
    path = tmp / "exported_learned_dicts.pt"
    export_reference_learned_dicts(ok, path)
    back = load_reference_learned_dicts(path, device=DEV)
    worst, flips = 0.0, 0
    for (ld, h), (bd, bh) in zip(ok, back):
        ld = ld.to(DEV)
        # the loader drops a do-nothing centering buffer (None)
        d = ld.get_learned_dict().shape[-1]
        trivial = {"centering_rot": torch.eye(d, device=DEV),
                   "centering_trans": torch.zeros(d, device=DEV),
                   "centering_scale": torch.ones(d, device=DEV)}
        compare(f"(d) {type(ld).__name__} dictionary", bd.get_learned_dict(),
                ld.get_learned_dict(), RTOL_INTEROP)
        for f in ("encoder_bias", *trivial, "k"):
            a = getattr(ld, f, None)
            if a is None:
                continue
            b = getattr(bd, f)
            if not isinstance(a, torch.Tensor):
                if a != b:
                    raise AssertionError(f"(d) {f}: {a} != {b}")
                continue
            compare(f"(d) {type(ld).__name__}.{f}",
                    trivial[f] if b is None else b, a, 0.0)
        xd = torch.randn(BATCH, d, generator=g).to(DEV)
        want = ld.encode(ld.center(xd))
        got = bd.encode(bd.center(xd))
        # the reference stores a TopK dict normalized, and its encode
        # normalizes again: a score within a rounding of the k-th largest
        # can change places with it (a selection flip, two codes)
        flipped = (got != 0) != (want != 0)
        n_flips = int(flipped.sum())
        flips = max(flips, n_flips)
        if n_flips > FLIPS_PER_CODE * want.numel():
            raise AssertionError(f"(d) {type(ld).__name__}: {n_flips} codes "
                                 "change sides of the selection")
        keep = ~flipped.any(dim=-1, keepdim=True)
        err = float(((got - want) * keep).abs().max()) / max(
            float(want.abs().max()), 1e-30)
        worst = max(worst, err)
    if worst > RTOL_INTEROP:
        raise AssertionError(f"(d) encode after the round trip {worst:.2e}")
    log(f"  (d) reference round trip: {len(ok)} dicts exported and loaded "
        f"back on the card (classes "
        f"{sorted({type(d).__name__ for d, _ in ok})}), encode within "
        f"{worst:.1e} ({flips} selection flips at most in a dict); refused "
        f"as in the JAX exporter: {sorted(set(refused))}")
    return {"exported": len(ok), "encode_rel_err": worst,
            "max_selection_flips": flips, "refused": sorted(set(refused))}


def zoo_phase(sweep_store: Path, tmp: Path) -> dict:
    """Phase 12 — the rest of slice 1 and the sweep's group experiments:
    (a) the recovery gate on the tied kernels and the metrics over a
    SparseMixDataset store; (b) the seven group experiments through the
    CLI, card against CPU; (c) a kill and resume of topk; (d) the
    reference round trip."""
    from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts

    rep = {"recovery": recovery_gate()}
    rep["mix"] = mix_sweep_and_metrics(tmp)
    rep["groups"] = group_experiments(sweep_store, tmp)
    rep["topk_resume"] = topk_kill_and_resume(
        sweep_store, tmp, Path(rep["groups"]["topk"]["out"]))
    pairs = ([(d, {"phase": "recovery"}) for d in rep["recovery"]["dicts"]]
             + rep["mix"]["dicts"])
    for exp, r in rep["groups"].items():
        pairs += load_learned_dicts(Path(r["out"]) / f"_{GROUP_CHUNKS - 1}"
                                    / f"{exp}_learned_dicts.pkl")
    rep["interop"] = reference_round_trip(tmp, pairs)
    del rep["recovery"]["dicts"], rep["mix"]["dicts"]
    return rep


# -- phase 16: the mesh (sparse_coding_tpu_torch/parallel) -------------------

MESH_STEPS = 3
# the two-rank world's meshes, model x data: members split (2 x 1) and
# rows split (1 x 2); both ranks share cuda:0, so these are correctness
# runs, not multi-GPU timings
MESH_SHAPES = ((2, 1), (1, 2))
MESH_BASIC_CHUNKS = 2  # (b): basic_l1_sweep over 2 chunks = 32 steps
MESH_WORLD_TIMEOUT_S = 600


def mesh_kernel_checks(g: torch.Generator, x_main: torch.Tensor,
                       big_store: Path) -> dict:
    """(a) Each chunked backward's data-sharded form (total_batch ≠ b: the
    rows of one shard of a two-way data axis, normalized by the batch of
    both) against its plain version with the same total_batch, fp32 and
    bf16, at the canonical shape (32 × 2048 × 512, batch 2048 —
    total_batch 4096) and at BigSAEArgs' (d=1024, n=16,384: 32,768 rows of
    a 65,536 batch), with phase 2's and phases 10-11's bounds and ReLU
    flip counting."""
    from sparse_coding_tpu_torch.data.chunk_store import ChunkStore
    from sparse_coding_tpu_torch.ops import fused_sae_tiled as ft

    inp = make_inputs(g, N_MEMBERS, BATCH, N_FEATS, D, x=x_main)
    e, dec, x, bias, al, cm = (inp[k] for k in ("e", "dec", "x", "bias",
                                                 "alphas", "cm"))
    tb = 2 * BATCH
    out = {}
    for mask, sfx in ((None, ""), (cm, "_masked")):
        r = ft.sae_tied_fwd_plain(e, bias, x, mask)
        got = ft.sae_tied_bwd(e, bias, al, x, r, mask, "float32", tb)
        ref = ft.sae_tied_bwd_plain(e, bias, al, x, r, mask, "float32", tb)
        pairs = bwd_pairs(got, ref, ("dw",), sfx)
        del pairs["dw" + sfx], pairs["db" + sfx]
        errs = {k: compare(f"mesh (a):sae_tied_bwd.{k}", *v)
                for k, v in pairs.items()}
        errs["flips"] = tied_bwd_flips(e, bias, al, x, r, mask, got[:2],
                                       ref[:2], f"mesh (a) total_batch{sfx}",
                                       total_batch=tb)
        out["sae_tied_bwd" + sfx] = errs
        del got, ref, r
    r = ft.sae_untied_fwd_plain(e, dec, bias, x)
    out["sae_untied_bwd"] = {
        k: compare(f"mesh (a):sae_untied_bwd.{k}", *v)
        for k, v in bwd_pairs(
            ft.sae_untied_bwd(e, dec, bias, al, x, r, "float32", tb),
            ft.sae_untied_bwd_plain(e, dec, bias, al, x, r, "float32", tb),
            ("de", "dwn")).items()}
    del r
    log("  (a) sae_tied_bwd (masked too) and sae_untied_bwd with "
        f"total_batch {tb} at batch {BATCH}: ok")
    out["sae_tied_bwd_bf16"] = bf16_bwd_check(inp, True, "mesh (a)",
                                              total_batch=tb)
    out["sae_tied_bwd_bf16_masked"] = bf16_bwd_check(
        inp, True, "mesh (a)", cm=cm, total_batch=tb)
    out["sae_untied_bwd_bf16"] = bf16_bwd_check(inp, False, "mesh (a)",
                                                total_batch=tb)
    del inp
    torch.cuda.empty_cache()
    rows = BIG_BATCH // 2
    xb = torch.as_tensor(ChunkStore(big_store).load_chunk(0)[:rows]).to(DEV)
    p = big_params(g, BIG_N, BIG_D)
    out["big"] = check_big_kernels(p, xb, "mesh (a) big",
                                   total_batch=BIG_BATCH)
    torch.cuda.empty_cache()
    out["big_bf16"] = big_bf16_check(p, xb, "mesh (a) big bf16",
                                     total_batch=BIG_BATCH)
    del xb, p
    torch.cuda.empty_cache()
    return out


def ld_tensors(ld) -> dict:
    """A LearnedDict's tensor fields."""
    import dataclasses

    return {f.name: getattr(ld, f.name) for f in dataclasses.fields(ld)
            if isinstance(getattr(ld, f.name), torch.Tensor)}


def mesh_nccl_one(store: Path, tmp: Path, l1_values) -> dict:
    """(b) A 1 × 1 mesh over NCCL, a world of one: ``basic_l1_sweep`` at the
    canonical shape on the mesh, then without it; the tied kernels launch
    once a step on the mesh run and its dicts equal the other run's bit
    for bit."""
    import torch.distributed as dist

    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.parallel.mesh import (
        initialize_distributed,
        make_mesh,
        shutdown_distributed,
    )
    from sparse_coding_tpu_torch.train.basic_sweep import basic_l1_sweep

    n_steps = MESH_BASIC_CHUNKS * ROWS_PER_CHUNK // BATCH
    initialize_distributed(store=dist.FileStore(str(tmp / "nccl_rdzv"), 1),
                           num_processes=1, process_id=0, backend="nccl",
                           device_type="cuda", timeout_s=300.0)
    try:
        mesh = make_mesh(1, 1, device_type="cuda")
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}")
        runs = {}
        for label, m in (("mesh", mesh), ("plain", None)):
            _build.reset_launches()
            sync()
            t0 = time.perf_counter()
            dicts = basic_l1_sweep(store, tmp / f"nccl_{label}", l1_values,
                                   dict_ratio=RATIO, batch_size=BATCH, lr=LR,
                                   seed=SEED, mesh=m,
                                   device=None if m is not None else DEV)
            sync()
            runs[label] = {"dicts": dicts, "launches": dict(_build.LAUNCHES),
                           "wall_s": time.perf_counter() - t0}
    finally:
        shutdown_distributed()
    launches = {k: runs["mesh"]["launches"][k] for k in TIED_KERNELS}
    if any(v != n_steps for v in launches.values()):
        raise AssertionError(f"(b) mesh launches {launches}, expected "
                             f"{n_steps} each")
    differing = []
    for i, ((a, _), (b, _)) in enumerate(zip(runs["mesh"]["dicts"],
                                             runs["plain"]["dicts"])):
        ta, tb_ = ld_tensors(a), ld_tensors(b)
        if set(ta) != set(tb_) or not all(
                torch.equal(ta[k].cpu(), tb_[k].cpu()) for k in ta):
            differing.append(i)
    if differing:
        raise AssertionError(f"(b) the 1x1 NCCL mesh's dicts {differing} "
                             "differ from the run without a mesh")
    log(f"  (b) 1x1 NCCL mesh: basic_l1_sweep {n_steps} steps, launches "
        f"{launches}, dicts bitwise equal to the run without a mesh; "
        f"{runs['mesh']['wall_s']:.1f} s vs {runs['plain']['wall_s']:.1f} s")
    return {"steps": n_steps, "launches": launches,
            "wall_s": {k: v["wall_s"] for k, v in runs.items()}}


def mesh_world(tmp: Path, store: Path, big_store: Path) -> dict:
    """(c) A two-rank gloo world whose ranks share cuda:0 (this script's
    ``--mesh-worker``, one process a rank): on the 2 × 1 and 1 × 2 meshes
    the tied and untied ensembles at the canonical shape on
    train_step_tiled and the big SAE at BigSAEArgs' shape in fp32 and
    bf16, MESH_STEPS steps each, every kernel of each path launching on
    each rank; rank 0 holds each run against the single-device run (phase
    6's and phase 7's side-by-side bounds). A rank that fails fails the
    phase."""
    out = tmp / "mesh_world"
    out.mkdir()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-worker",
         str(r), "2", str(out / "rdzv"), str(out), str(store),
         str(big_store)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=MESH_WORLD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, logs)):
        for line in text.splitlines():
            if line.startswith("[mesh"):
                log("  " + line)
        if p.returncode != 0:
            raise AssertionError(f"(c) mesh world rank {r} exited "
                                 f"{p.returncode}:\n{text[-6000:]}")
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(2)]
    for r, res in enumerate(ranks):
        for run, launches in res["launches"].items():
            if any(v != MESH_STEPS for v in launches.values()):
                raise AssertionError(f"(c) rank {r} {run}: launches "
                                     f"{launches}")
    return {"ranks": ranks}


def mesh_worker(argv) -> int:
    """One rank of phase 16 (c)'s world: ``--mesh-worker RANK WORLD RDZV
    OUT STORE BIG_STORE``."""
    import torch.distributed as dist

    from sparse_coding_tpu_torch.parallel.mesh import (
        initialize_distributed,
        shutdown_distributed,
    )

    rank, world = int(argv[0]), int(argv[1])
    rdzv, out, store, big_store = (Path(a) for a in argv[2:6])
    initialize_distributed(store=dist.FileStore(str(rdzv), world),
                           num_processes=world, process_id=rank,
                           backend="gloo", device_type=DEV,
                           timeout_s=300.0)
    try:
        res = mesh_worker_runs(rank, store, big_store)
        (out / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        shutdown_distributed()
    return 0


def mesh_worker_runs(rank: int, store: Path, big_store: Path) -> dict:
    from sparse_coding_tpu_torch.data.chunk_store import ChunkStore
    from sparse_coding_tpu_torch.ensemble import Ensemble
    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.parallel.mesh import make_mesh
    from sparse_coding_tpu_torch.train import big_sae as bs

    dev = torch.device("cuda", 0) if DEV == "cuda" else torch.device(DEV)
    say = lambda msg: print(f"[mesh rank {rank}] {msg}", flush=True)
    meshes = {f"{m}x{d}": make_mesh(m, d, device=dev) for m, d in MESH_SHAPES}
    l1_values = [float(v) for v in np.logspace(-4, -2, N_MEMBERS)]
    chunk = ChunkStore(store).load_chunk(1)
    batches = [torch.as_tensor(chunk[i * BATCH:(i + 1) * BATCH]).to(dev)
               for i in range(MESH_STEPS)]
    res = {"launches": {}, "step_ms": {}, "checks": {}}

    def timed(run, label: str, kernels):
        _build.reset_launches()
        sync()
        t0 = time.perf_counter()
        value = run()
        sync()
        res["step_ms"][label] = 1e3 * (time.perf_counter() - t0) / MESH_STEPS
        res["launches"][label] = {k: _build.LAUNCHES[k] for k in kernels}
        return value

    for family in ("tied", "untied"):
        kernels = TIED_KERNELS if family == "tied" else UNTIED_KERNELS
        weights = ("encoder", "decoder") if family == "untied" \
            else ("encoder",)
        got = {}
        for label, mesh in meshes.items():
            sig, members = family_members(family, l1_values)
            ens = Ensemble(members, sig, lr=LR, fused_path="train_step_tiled",
                           mesh=mesh)
            losses = timed(lambda: [ens.step_batch(b).losses["loss"]
                                    for b in batches],
                           f"{family} {label}", kernels)
            full = ens.full_state()
            got[label] = (losses, {w: full.params[w] for w in weights})
            del ens, full
        if rank == 0:
            sig, members = family_members(family, l1_values)
            ref = Ensemble(members, sig, lr=LR, fused_path="train_step_tiled",
                           device=dev)
            ref_losses = [ref.step_batch(b).losses["loss"] for b in batches]
            for label, (losses, params) in got.items():
                name = f"{family} {label}"
                errs = [compare(f"(c) {name} step {i} loss", g, w,
                                RTOL_PATH_LOSS)
                        for i, (g, w) in enumerate(zip(losses, ref_losses))]
                fro = {w: rel_fro(params[w], ref.state.params[w])
                       for w in weights}
                if not all(v <= REL_FRO_PATH for v in fro.values()):
                    raise AssertionError(f"(c) {name}: weights drifted from "
                                         f"the single device: {fro}")
                res["checks"][name] = {
                    "loss_max_rel_err": max(e["max_rel_err"] for e in errs),
                    "rel_fro": fro}
                say(f"{name}: vs one device: loss rel err "
                    f"{res['checks'][name]['loss_max_rel_err']:.2e}, "
                    f"relative Frobenius {fro}")
            del ref
        del got
        torch.cuda.empty_cache()
    del batches

    cs = ChunkStore(big_store)
    rows = [cs.load_chunk(0)[:BIG_BATCH], cs.load_chunk(0)[BIG_BATCH:],
            cs.load_chunk(1)[:BIG_BATCH]]
    big_batches = [torch.as_tensor(r).to(dev) for r in rows[:MESH_STEPS]]
    for cd in ("float32", BF16):
        sfx = "" if cd == "float32" else "_bf16"
        kernels = tuple(k + sfx for k in BIG_KERNELS)
        got = {}
        for label, mesh in meshes.items():
            state, opt, l1 = bs.init_big_sae(
                torch.Generator().manual_seed(1), BIG_D, BIG_N, BIG_L1,
                lr=BIG_LR, device="cpu")
            state = bs.shard_big_sae(state, mesh)
            step = bs.make_big_sae_step(opt, l1.to(dev), mesh=mesh,
                                        fused_compute_dtype=cd)

            def run():
                nonlocal state
                ms = []
                for b in big_batches:
                    state, m = step(state, b)
                    ms.append(m)
                return ms

            ms = timed(run, f"big{sfx} {label}", kernels)
            got[label] = (ms, bs.gather_big_sae(state, mesh).params)
            del state
        if rank == 0:
            state, opt, l1 = bs.init_big_sae(
                torch.Generator().manual_seed(1), BIG_D, BIG_N, BIG_L1,
                lr=BIG_LR, device=dev)
            step = bs.make_big_sae_step(opt, l1, use_fused=True,
                                        fused_compute_dtype=cd)
            ref = []
            for b in big_batches:
                state, m = step(state, b)
                ref.append(m)
            for label, (ms, params) in got.items():
                name = f"big{sfx} {label}"
                errs = [compare(f"(c) {name} step {i} {k}", g[k], w[k],
                                RTOL_BIG_STEP)
                        for i, (g, w) in enumerate(zip(ms, ref)) for k in w]
                fro = {k: rel_fro(params[k], state.params[k])
                       for k in bs.PARAM_NAMES}
                if not all(v <= REL_FRO_BIG_REPLAY for v in fro.values()):
                    raise AssertionError(f"(c) {name}: params drifted from "
                                         f"the single device: {fro}")
                res["checks"][name] = {
                    "metrics_max_rel_err": max(e["max_rel_err"]
                                               for e in errs),
                    "rel_fro": fro}
                say(f"{name}: vs one device: metrics rel err "
                    f"{res['checks'][name]['metrics_max_rel_err']:.2e}, "
                    f"relative Frobenius {fro}")
            del state, ref
        del got
        torch.cuda.empty_cache()
    say(f"launches {res['launches']}; ms a step {res['step_ms']}")
    return res


def mesh_phase(tmp: Path, x_main: torch.Tensor, big_store: Path,
               l1_values) -> dict:
    t0 = time.perf_counter()
    out = {"a": mesh_kernel_checks(torch.Generator().manual_seed(16),
                                   x_main, big_store)}
    store = tmp / "mesh_store"
    write_store(store, MESH_BASIC_CHUNKS * ROWS_PER_CHUNK, seed=SEED + 16)
    out["b"] = mesh_nccl_one(store, tmp, l1_values)
    out["c"] = mesh_world(tmp, store, big_store)
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 16: {out['wall_s']:.1f} s")
    return out


# -- phase 17: serving at the LM's width (sparse_coding_tpu_torch/serve) -----

# the engine's ops: DEFAULT_OPS + predict + CATALOG_OPS (vote: the stack)
SERVE_OPS = ("encode", "decode", "topk", "predict", "neighbors", "vote")
SERVE_TOPK = 16  # the engine's k (topk, neighbors)
SERVE_PER_OP = 48  # (c) requests a burst, one burst an op
SERVE_WAVE = 16  # (c) requests in flight together
SERVE_MAX_ROWS = 512
SERVE_CPU_BUCKET = 8  # (b) card vs CPU at this bucket (5 rows)
SERVE_CATALOG_BUCKETS = (16,)
SERVE_CATALOG_K = 8
SERVE_BUDGET_S = 45.0
# (f)'s restarted process: this script with --serve-restart
SERVE_CHILD = (sys.executable, str(Path(__file__).resolve()),
               "--serve-restart")


def serve_captures() -> int:
    from sparse_coding_tpu_torch.obs import get_registry

    return get_registry().counter("xcache.captures").value


def serve_registry(dict_file: Path, device):
    """Phase 13's tied mlp.2 dicts as a serving registry: the first one
    through ``load_native`` (its L1 value selects it) as ``mlp2/0``, and
    the 16 as one stack, ``mlp2/stack``. Returns the registry and the
    dicts."""
    from sparse_coding_tpu_torch.serve import ModelRegistry
    from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts

    pairs = load_learned_dicts(dict_file, device=device)
    reg = ModelRegistry(device=device)
    first = pairs[0][1]["l1_alpha"]
    names = reg.load_native(dict_file, prefix="mlp2",
                            select=lambda h: h["l1_alpha"] == first)
    if names != ["mlp2/0"]:
        raise AssertionError(f"load_native selected {names}")
    reg.register_stack("mlp2/stack", [ld for ld, _ in pairs],
                       [h for _, h in pairs])
    return reg, pairs


def serve_gateway(reg, device):
    """The gateway of (a): 2 active replicas and a spare over one
    program table, the default ladder, SERVE_OPS; breakers open on one
    failure so (d)'s drill trips exactly one replica."""
    from sparse_coding_tpu_torch.serve import ServingGateway

    return ServingGateway(reg, n_replicas=2, n_spares=1, ops=SERVE_OPS,
                          max_queue_rows=1 << 20, breaker_threshold=1,
                          breaker_reset_s=3600.0,
                          engine_kwargs={"topk_k": SERVE_TOPK},
                          device=device)


def serve_programs(reg, ops=SERVE_OPS, buckets=(8, 64, 512)) -> set:
    return {(m, op, b) for m in reg.names() for op in ops for b in buckets
            if op != "vote" or reg.get(m).is_stack}


def serve_payload(rs, op: str, rows: np.ndarray, r: int,
                  n_feats: int) -> np.ndarray:
    """``r`` request rows for ``op``: harvested rows (unit rows for
    neighbors), sparse nonnegative codes for decode."""
    if op == "decode":
        return (rs.random((r, n_feats)) * (rs.random((r, n_feats)) < 0.01)
                ).astype(np.float32)
    i = int(rs.integers(0, rows.shape[0] - r))
    x = rows[i:i + r]
    if op == "neighbors":
        x = x / np.linalg.norm(x, axis=-1, keepdims=True)
    return np.ascontiguousarray(x, dtype=np.float32)


def serve_leaves(tree) -> tuple:
    return tree if isinstance(tree, tuple) else (tree,)


def serve_eager(entry, tree, op: str, x: np.ndarray, bucket: int,
                device) -> tuple:
    """The op's plain eager program on ``x`` zero-padded to ``bucket`` on
    ``device``, cut to the request rows, as host arrays."""
    from sparse_coding_tpu_torch.serve.engine import (
        build_bucket_program,
        op_rows_axis,
    )

    fn, spec = build_bucket_program(entry, op, bucket, torch.float32,
                                    SERVE_TOPK)
    padded = torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    padded[:x.shape[0]] = torch.from_numpy(x).to(device)
    with torch.no_grad():
        out = fn(tree, padded)
    sl = (slice(None),) * op_rows_axis(entry, op) + (slice(0, x.shape[0]),)
    return tuple(t[sl].cpu().numpy() for t in serve_leaves(out))


def serve_near_ties(label: str, got_idx, ref_idx, score, bound: float) -> int:
    """Top-k indices equal but where the two picks' scores (``score``:
    the reference side's values, indexed like the result's last axis
    over the feature axis) lie within ``bound``; returns the swaps."""
    moved = np.nonzero(got_idx != ref_idx)
    for pos in zip(*moved):
        row = score[pos[:-1]]
        a, b = float(row[got_idx[pos]]), float(row[ref_idx[pos]])
        if not abs(a - b) <= bound:
            raise AssertionError(f"{label} {pos}: index {got_idx[pos]} vs "
                                 f"{ref_idx[pos]} is no near-tie "
                                 f"({a} vs {b})")
    return int(len(moved[0]))


def serve_card_vs_cpu(reg, cpu_trees: dict, graph: dict) -> dict:
    """(b) each (model, op)'s request at SERVE_CPU_BUCKET through the
    graphs against the port's eager op on the CPU: values within
    RTOL_EVAL of max|ref|; topk/neighbors indices equal but at near-ties
    within that bound; vote counts equal but one flip per million
    codes."""
    from sparse_coding_tpu_torch.catalog.query import unpack_neighbors

    out = {"near_ties": 0, "vote_flips": 0}
    for (model, op), (x, got) in graph.items():
        entry = reg.get(model)
        ref = serve_eager(entry, cpu_trees[model], op, x, SERVE_CPU_BUCKET,
                          "cpu")
        label = f"(b) {model}/{op} card vs CPU"
        if op in ("topk", "neighbors"):
            if op == "topk":
                gv, gi = got
                rv, ri = ref
                score = serve_eager(entry, cpu_trees[model], "encode", x,
                                    SERVE_CPU_BUCKET, "cpu")[0]
            else:
                gv, gi = unpack_neighbors(got[0])
                rv, ri = unpack_neighbors(ref[0])
                score = serve_sims(cpu_trees[model], x, entry.is_stack)
            bound = RTOL_EVAL * float(np.abs(rv).max())
            compare(label, torch.from_numpy(gv), torch.from_numpy(rv),
                    RTOL_EVAL)
            out["near_ties"] += serve_near_ties(label, gi, ri, score, bound)
        elif op == "vote":
            flips = int(np.abs(got[0] - ref[0]).sum())
            codes = entry.n_stack * got[0].size
            if not flips <= FLIPS_PER_CODE * codes:
                raise AssertionError(f"{label}: {flips} flips in {codes}")
            out["vote_flips"] += flips
        else:
            compare(label, torch.from_numpy(got[0]), torch.from_numpy(ref[0]),
                    RTOL_EVAL)
    return out


def serve_sims(tree, x: np.ndarray, stack: bool) -> np.ndarray:
    """x · Dᵀ on the CPU (a stack's per member): neighbors' scores."""
    from sparse_coding_tpu_torch.utils.trees import tree_index, tree_len

    q = torch.from_numpy(x)
    if not stack:
        return (q @ tree.get_learned_dict().T).numpy()
    return np.stack([(q @ tree_index(tree, i).get_learned_dict().T).numpy()
                     for i in range(tree_len(tree))])


def serve_bitwise(reg, eng, rows: np.ndarray, rs) -> tuple[dict, dict]:
    """(b) every (model, op, bucket) program at a partial bucket through
    its graph against the eager op on the card at the same padded bucket:
    bitwise. Returns the count and the SERVE_CPU_BUCKET requests and
    results for the CPU comparison."""
    checked, for_cpu = 0, {}
    for model in reg.names():
        entry = reg.get(model)
        tree = eng._entry_tree(model)
        for op in SERVE_OPS:
            if op == "vote" and not entry.is_stack:
                continue
            for bucket in eng.buckets:
                x = serve_payload(rs, op, rows, bucket - 3, entry.n_feats)
                _, got = eng.run_padded(model, op, x)
                got = serve_leaves(got)
                ref = serve_eager(entry, tree, op, x, bucket, DEV)
                for g, r in zip(got, ref):
                    if g.shape != r.shape or not np.array_equal(
                            g.view(np.int32), r.view(np.int32)):
                        raise AssertionError(
                            f"(b) {model}/{op} bucket {bucket}: graph vs "
                            "eager at the same padded bucket not bitwise")
                checked += 1
                if bucket == SERVE_CPU_BUCKET:
                    for_cpu[(model, op)] = (x, got)
    return {"programs": checked}, for_cpu


def serve_traffic(gw, reg, rows: np.ndarray, rs) -> dict:
    """(c) one burst an op: SERVE_PER_OP requests of 1-512 rows
    (log-uniform, seeded) over the models serving the op, SERVE_WAVE in
    flight; rows/s per op, then p50/p99 per bucket."""
    from sparse_coding_tpu_torch.serve import INTERACTIVE

    per_op = {}
    for op in SERVE_OPS:
        models = [m for m in reg.names()
                  if op != "vote" or reg.get(m).is_stack]
        sizes = np.clip(np.exp(rs.uniform(0, np.log(SERVE_MAX_ROWS),
                                          SERVE_PER_OP)).astype(int),
                        1, SERVE_MAX_ROWS)
        reqs = [(models[i % len(models)],
                 serve_payload(rs, op, rows, int(r),
                               reg.get(models[i % len(models)]).n_feats))
                for i, r in enumerate(sizes)]
        t0 = time.perf_counter()
        for w in range(0, len(reqs), SERVE_WAVE):
            futs = [gw.submit(m, x, op=op, priority=INTERACTIVE)
                    for m, x in reqs[w:w + SERVE_WAVE]]
            for (m, x), f in zip(reqs[w:w + SERVE_WAVE], futs):
                res = serve_leaves(f.result(timeout=120))
                axis = 1 if (reg.get(m).is_stack and op != "vote") else 0
                if (res[0].shape[axis] != x.shape[0]
                        or not all(np.isfinite(a).all() for a in res)):
                    raise AssertionError(f"(c) {m}/{op}: bad result")
        wall = time.perf_counter() - t0
        n_rows = int(sizes.sum())
        per_op[op] = {"requests": len(reqs), "rows": n_rows, "wall_s": wall,
                      "rows_per_s": n_rows / wall}
    snap = gw.stats()
    lat = {b: {"batches": v["batches"], "fill": v["fill_ratio"],
               "p50_ms": v["p50_ms"], "p99_ms": v["p99_ms"]}
           for b, v in snap["buckets"].items()}
    return {"per_op": per_op, "buckets": lat}


def serve_recompiles(gw) -> int:
    return sum(r["recompiles"] for r in gw.stats()["replicas"].values())


def serve_drills(gw, reg, rows: np.ndarray, rs) -> dict:
    """(d) trip the primary replica with the serve.dispatch fault plan
    (every request answered by failover, the breaker's transitions
    recorded), the spare's activation at 0 captures, then a swap to the
    ladder derived from (c)'s traffic capturing only the new rungs."""
    from sparse_coding_tpu_torch.resilience.faults import inject
    from sparse_coding_tpu_torch.serve import INTERACTIVE
    from sparse_coding_tpu_torch.serve.ladder import (
        derive_ladder,
        parse_snapshot,
        snapshot_bytes,
    )

    gw.configure_hedging(3600.0)  # the failover path, not a hedge, answers
    c0 = serve_captures()
    with inject(site="serve.dispatch", nth=1, count=1, error="OSError",
                message="phase 17 drill") as plan:
        for _ in range(8):
            x = serve_payload(rs, "encode", rows, 5, 0)
            out = gw.query("mlp2/0", x, op="encode", priority=INTERACTIVE,
                           timeout=60)
            if out.shape != (5, reg.get("mlp2/0").n_feats):
                raise AssertionError("(d) drill result shape")
    snap = gw.stats()
    tripped = [n for n, r in snap["replicas"].items()
               if r["breaker"]["state"] == "open"]
    g = snap["gateway"]
    if (plan.fired != [("serve.dispatch", 1)] or len(tripped) != 1
            or snap["replicas"][tripped[0]]["state"] != "draining"
            or snap["replicas"]["spare-0"]["state"] != "active"
            or g["spare_activations"] != 1 or g["failovers"] < 1
            or snap["request_errors"]):
        raise AssertionError(f"(d) drill: tripped {tripped}, {g}, "
                             f"errors {snap['request_errors']}")
    drill_captures = serve_captures() - c0
    if drill_captures:
        raise AssertionError(f"(d) the spare's activation captured "
                             f"{drill_captures} programs")
    transitions = snap["replicas"][tripped[0]]["breaker"]["transitions"]
    cand = derive_ladder(parse_snapshot(snapshot_bytes(gw.metrics.registry)))
    rungs = tuple(cand["rungs"])
    old = gw.active_buckets
    new = sorted(set(rungs) - set(old))
    want = len(serve_programs(reg, buckets=new))
    c1 = serve_captures()
    swap = gw.swap_ladder(rungs, source="derived")
    swap_captures = serve_captures() - c1
    if not swap_captures == swap["programs_warmed"] == want:
        raise AssertionError(f"(d) the swap to {rungs} captured "
                             f"{swap_captures} ({swap['programs_warmed']}) "
                             f"programs; its new rungs {new} need {want}")
    for r in (1, rungs[0], rungs[-1]):
        x = serve_payload(rs, "encode", rows, r, 0)
        gw.query("mlp2/stack", x, op="encode", priority=INTERACTIVE,
                 timeout=60)
    if serve_recompiles(gw) or serve_captures() != c1 + swap_captures:
        raise AssertionError("(d) serving after the swap captured")
    return {"tripped": tripped[0], "transitions": transitions,
            "failovers": g["failovers"], "spare_captures": drill_captures,
            "ladder": list(rungs), "old_ladder": list(old),
            "new_rungs": new, "swap_captures": swap_captures,
            "expected_pad_rows": cand["expected_pad_rows"]}


def serve_catalog(pairs, catalog_dir: Path, rows: np.ndarray) -> dict:
    """(e) CatalogService stats/neighbors/search/union over phase 15's
    catalog on a catalog gateway (16 single dicts + the stack, ops
    CATALOG_OPS) on the card and the same on the CPU: stats equal,
    neighbor cosines within RTOL_EVAL and features equal but at near-ties
    within it, union masks equal but one flip per million codes."""
    from sparse_coding_tpu_torch.catalog import CatalogIndex, CatalogService
    from sparse_coding_tpu_torch.serve import (
        CATALOG_OPS,
        ModelRegistry,
        ServingGateway,
    )

    index = CatalogIndex.load(catalog_dir, verify=True)
    if index.n_dicts != len(pairs):
        raise AssertionError(f"(e) catalog of {index.n_dicts} dicts for "
                             f"{len(pairs)} loaded")
    live = np.nonzero(~index.dead(0))[0]
    feats = [int(live[0]), int(live[len(live) // 2]), int(live[-1])]
    q = rows[:4] / np.linalg.norm(rows[:4], axis=-1, keepdims=True)
    answers, walls = {}, {}
    for side, dev in (("card", DEV), ("cpu", "cpu")):
        reg = ModelRegistry(device=dev)
        members = [ld.to(dev) for ld, _ in pairs]
        for i, ld in enumerate(members):
            reg.register(f"cat/{i}", ld)
        reg.register_stack("cat/stack", members)
        gw = ServingGateway(reg, n_replicas=1, n_spares=0, ops=CATALOG_OPS,
                            buckets=SERVE_CATALOG_BUCKETS, device=dev)
        gw.warmup()
        svc = CatalogService(index, gw, [f"cat/{i}" for i in range(len(pairs))],
                             stack_model="cat/stack")
        t0 = time.perf_counter()
        answers[side] = {
            "stats": [svc.stats(0, f) for f in feats],
            "neighbors": [svc.neighbors(0, f, k=SERVE_CATALOG_K)
                          for f in feats],
            "search": svc.search(1, q, k=SERVE_CATALOG_K),
            "union": svc.union(rows[:16], quorum=2)}
        walls[side] = time.perf_counter() - t0
        gw.shutdown()
        del reg, members, gw
    card, cpu = answers["card"], answers["cpu"]
    if card["stats"] != cpu["stats"]:
        raise AssertionError("(e) feature.stats card vs CPU")
    sims0 = index.rows(0)[feats] @ index.rows(0).T
    sims1 = q @ index.rows(1).T
    ties = 0
    hit_lists = [(g, r, s) for g, r, s in
                 zip(card["neighbors"], cpu["neighbors"], sims0)]
    hit_lists += [(g, r, s) for g, r, s in
                  zip(card["search"], cpu["search"], sims1)]
    for got, ref, score in hit_lists:
        if len(got) != len(ref):
            raise AssertionError("(e) neighbor list lengths card vs CPU")
        for a, b in zip(got, ref):
            if not abs(a["cos"] - b["cos"]) <= RTOL_EVAL:
                raise AssertionError(f"(e) neighbor cos {a} vs {b}")
            if a["feature"] != b["feature"]:
                if not abs(score[a["feature"]] - score[b["feature"]]) \
                        <= RTOL_EVAL:
                    raise AssertionError(f"(e) neighbor {a} vs {b} is no "
                                         "near-tie")
                ties += 1
    flips = int((card["union"] != cpu["union"]).sum())
    codes = len(pairs) * card["union"].size
    if not flips <= FLIPS_PER_CODE * codes:
        raise AssertionError(f"(e) union: {flips} flips in {codes} codes")
    return {"features": feats, "near_ties": ties, "union_flips": flips,
            "card_s": walls["card"], "cpu_s": walls["cpu"],
            "neighbors": card["neighbors"][0][:3]}


def serve_restart_child(argv) -> int:
    """(f) a restarted serving process: ``--serve-restart CACHE_DIR
    DICT_FILE OUT``. Loads the kernel libraries (no nvcc may run), builds
    (a)'s registry and gateway, warms from the manifest in CACHE_DIR, then
    admits traffic; writes its counts and first-request latency to OUT."""
    from sparse_coding_tpu_torch import xcache
    from sparse_coding_tpu_torch.serve import INTERACTIVE

    cache_dir, dict_file, out = (Path(a) for a in argv)
    t0 = time.perf_counter()
    cache = xcache.enable(cache_dir)
    manifest = {(d["model"], d["op"], int(d["bucket"]))
                for d in cache.warmup.descriptors(kind="serve")}
    nvcc = xcache.load_kernel_libraries()
    reg, pairs = serve_registry(dict_file, DEV)
    del pairs
    gw = serve_gateway(reg, DEV)
    c0 = serve_captures()
    warmed = sum(gw.replica(n).engine.warmup_from_manifest()
                 for n in gw.active_replica_names())
    captured = serve_captures() - c0
    table = set(gw.replica("replica-0").engine.program_cache.compiled)
    ready_s = time.perf_counter() - t0
    rs = np.random.default_rng(SEED + 171)
    x = rs.normal(size=(5, reg.get("mlp2/0").d_activation)).astype(
        np.float32)
    t1 = time.perf_counter()
    first = gw.query("mlp2/0", x, op="encode", priority=INTERACTIVE,
                     timeout=60)
    first_ms = 1e3 * (time.perf_counter() - t1)
    c1 = serve_captures()
    for op in SERVE_OPS:
        xx = (rs.random((7, reg.get("mlp2/0").n_feats)).astype(np.float32)
              if op == "decode" else x)
        gw.query("mlp2/stack", xx, op=op, priority=INTERACTIVE, timeout=60)
    res = {"nvcc_runs": nvcc, "manifest": len(manifest),
           "captures": captured, "warmed": warmed,
           "table_is_manifest": table == manifest,
           "captures_after_admission": serve_captures() - c1,
           "recompiles": serve_recompiles(gw), "ready_s": ready_s,
           "first_request_ms": first_ms,
           "first_shape": list(first.shape)}
    gw.shutdown()
    out.write_text(json.dumps(res))
    return 0


def serve_phase(tmp: Path, dict_file: Path, store2: Path,
                catalog_dir: Path) -> dict:
    """Phase 17: (a) registry and warmup, (b) correctness, (c) online
    traffic, (d) drills, (e) offline and catalog, (f) restart — on phase
    13's 16 tied mlp.2 dicts, its harvested rows and phase 15 (f)'s
    catalog."""
    import shutil

    from sparse_coding_tpu_torch import xcache
    from sparse_coding_tpu_torch.data.chunk_store import ChunkStore
    from sparse_coding_tpu_torch.ops.roofline import serve_flush_plan
    from sparse_coding_tpu_torch.serve import score_offline

    t_phase = time.perf_counter()
    rep: dict = {"walls_s": {}}
    walls, t_mark = rep["walls_s"], [t_phase]

    def mark(step: str) -> None:  # the wall of each step, for PERF.md §5
        now = time.perf_counter()
        walls[step] = now - t_mark[0]
        t_mark[0] = now

    rs = np.random.default_rng(SEED + 17)
    rows = np.asarray(ChunkStore(store2).load_chunk(0), dtype=np.float32)
    cache = xcache.enable(tmp / "serve_xcache")
    # (a)
    t0 = time.perf_counter()
    reg, pairs = serve_registry(dict_file, DEV)
    load_s = time.perf_counter() - t0
    gw = serve_gateway(reg, DEV)
    c0 = serve_captures()
    t0 = time.perf_counter()
    n = gw.warmup()
    warm_s = time.perf_counter() - t0
    want = serve_programs(reg)
    table = gw.replica("replica-0").engine.program_cache
    if not n == serve_captures() - c0 == len(want) or set(
            table.compiled) != want:
        raise AssertionError(f"(a) warmup captured {n} programs, want "
                             f"{len(want)}")
    rep["a"] = {"captures": n, "warmup_s": warm_s, "load_s": load_s,
                "pool_bytes": table.pool_bytes(),
                "pinned_bytes": table.pinned_bytes()}
    pool = rep["a"]["pool_bytes"]
    log(f"  (a) registry mlp2/0 + mlp2/stack ({len(pairs)} dicts, d="
        f"{reg.get('mlp2/0').d_activation}, n={reg.get('mlp2/0').n_feats}) "
        f"loaded in {load_s:.2f} s; warmup captured {n} programs (2 models "
        f"x {len(SERVE_OPS)} ops, vote stack-only, x 3 buckets) in "
        f"{warm_s:.2f} s; graph pool "
        + (f"{pool / 2**20:.1f} MiB" if pool is not None else "not measured")
        + f", pinned staging {rep['a']['pinned_bytes'] / 2**20:.1f} MiB")
    restart = tmp / "serve_restart"
    restart.mkdir()
    shutil.copy(cache.warmup.path, restart / "warmup.json")
    mark("a")
    # (f)'s child starts now and runs beside the untimed checks, (b)'s and
    # (e)'s catalog service
    child_out = tmp / "serve_restart.json"
    child_log = open(tmp / "serve_restart.log", "w")
    child = subprocess.Popen(
        [*SERVE_CHILD, str(restart), str(dict_file), str(child_out)],
        stdout=child_log, stderr=subprocess.STDOUT)
    try:
        # (b)
        eng = gw.replica("replica-0").engine
        rep["b"], for_cpu = serve_bitwise(reg, eng, rows, rs)
        cpu_trees = {m: reg.get(m).tree.to("cpu") for m in reg.names()}
        rep["b"].update(serve_card_vs_cpu(reg, cpu_trees, for_cpu))
        del cpu_trees
        mark("b")
        catalog = serve_catalog(pairs, catalog_dir, rows)
        mark("e_catalog")
        rc = child.wait(timeout=600)
        mark("f_child_wait")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        child_log.close()
    if rc != 0:
        raise AssertionError(f"(f) restart child exit {rc}: "
                             + (tmp / "serve_restart.log").read_text()[-3000:])
    from sparse_coding_tpu_torch.catalog.query import (
        neighbor_topk,
        neighbor_topk_plain,
    )

    ld0 = eng._entry_tree("mlp2/0")
    q = torch.from_numpy(serve_payload(rs, "neighbors", rows, 512, 0)).to(DEV)
    fast, plain = neighbor_topk(ld0, q, SERVE_TOPK), neighbor_topk_plain(
        ld0, q, SERVE_TOPK)
    if not torch.equal(fast.view(torch.int32), plain.view(torch.int32)):
        raise AssertionError("(b) neighbor_topk vs its stable-sort plain "
                             "version")
    topk_ms = time_ms(lambda: neighbor_topk(ld0, q, SERVE_TOPK), 20)
    plain_ms = time_ms(lambda: neighbor_topk_plain(ld0, q, SERVE_TOPK), 20)
    rep["b"].update({"neighbor_topk_ms": topk_ms,
                     "neighbor_topk_plain_ms": plain_ms})
    mark("b_neighbor_topk")
    log(f"  (b) {rep['b']['programs']} programs bitwise the eager op at "
        f"the same padded bucket; card vs CPU at bucket {SERVE_CPU_BUCKET} "
        f"within RTOL_EVAL, {rep['b']['near_ties']} top-k near-tie swaps, "
        f"{rep['b']['vote_flips']} vote flips; neighbor_topk at 512 x "
        f"{reg.get('mlp2/0').n_feats} equals its plain version, "
        f"{topk_ms:.3f} ms vs {plain_ms:.3f} ms (stable sort)")
    # (c)
    c1 = serve_captures()
    rep["c"] = serve_traffic(gw, reg, rows, rs)
    rep["c"]["recompiles"] = serve_recompiles(gw)
    rep["c"]["captures"] = serve_captures() - c1
    if rep["c"]["recompiles"] or rep["c"]["captures"]:
        raise AssertionError(f"(c) {rep['c']['recompiles']} recompiles, "
                             f"{rep['c']['captures']} captures after warmup")
    log("  (c) 2 active replicas + 1 spare, "
        f"{SERVE_PER_OP} requests an op of 1-{SERVE_MAX_ROWS} rows: rows/s "
        + ", ".join(f"{op} {v['rows_per_s']:.0f}"
                    for op, v in rep["c"]["per_op"].items())
        + "; p50/p99 ms by bucket "
        + ", ".join(f"{b}: {v['p50_ms']:.2f}/{v['p99_ms']:.2f} "
                    f"(fill {v['fill']:.2f})"
                    for b, v in rep["c"]["buckets"].items())
        + "; 0 recompiles after warmup")
    mark("c")
    # (d)
    rep["d"] = serve_drills(gw, reg, rows, rs)
    mark("d")
    d = rep["d"]
    log(f"  (d) serve.dispatch tripped {d['tripped']} (transitions "
        f"{d['transitions']}), {d['failovers']} failovers, every request "
        f"answered; spare activated with {d['spare_captures']} captures; "
        f"ladder {d['old_ladder']} -> derived {d['ladder']} captured "
        f"{d['swap_captures']} programs (new rungs {d['new_rungs']})")
    # (e)
    t0 = time.perf_counter()
    enc = score_offline(eng, "mlp2/0", rows, op="encode")
    off_s = time.perf_counter() - t0
    slab = eng.buckets[-1]
    if enc.shape != (rows.shape[0], reg.get("mlp2/0").n_feats) or not \
            np.isfinite(enc).all() or not np.array_equal(
                enc[:slab], eng.run_padded("mlp2/0", "encode",
                                           rows[:slab])[1]):
        raise AssertionError("(e) score_offline")
    plan = serve_flush_plan("encode", slab, reg.get("mlp2/0").n_feats,
                            reg.get("mlp2/0").d_activation)
    rep["e"] = {"offline_rows": rows.shape[0], "offline_s": off_s,
                "offline_rows_per_s": rows.shape[0] / off_s,
                "slab_bound_ms": 1e3 * plan.est_s}
    del enc
    mark("e_offline")
    rep["e"]["catalog"] = cat = catalog
    log(f"  (e) score_offline encode over {rows.shape[0]} rows: "
        f"{rep['e']['offline_rows_per_s']:.0f} rows/s ({off_s:.2f} s; a "
        f"{slab}-row slab's roofline {rep['e']['slab_bound_ms']:.3f} ms); "
        f"CatalogService stats/neighbors/search/union card vs CPU equal "
        f"({cat['near_ties']} near-tie swaps, {cat['union_flips']} union "
        f"flips; card {cat['card_s']:.2f} s, CPU {cat['cpu_s']:.2f} s)")
    # (f)
    child_res = json.loads(child_out.read_text())
    rep["f"] = child_res
    if not (child_res["nvcc_runs"] == 0
            and child_res["captures"] == child_res["manifest"]
            == rep["a"]["captures"] and child_res["table_is_manifest"]
            and child_res["captures_after_admission"] == 0
            and child_res["recompiles"] == 0):
        raise AssertionError(f"(f) restart {child_res}")
    log(f"  (f) restart from (a)'s manifest: {child_res['captures']} "
        f"captures = the manifest's {child_res['manifest']}, 0 nvcc runs, "
        f"ready in {child_res['ready_s']:.2f} s, first request "
        f"{child_res['first_request_ms']:.2f} ms, 0 captures after "
        "admission")
    gw.shutdown()
    xcache.disable()
    rep["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 17: {rep['wall_s']:.1f} s (budget {SERVE_BUDGET_S:.0f} s): "
        + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    return rep


# -- phase 18: the supervised pipeline (sparse_coding_tpu_torch/pipeline) ---

# harvest → sweep → eval → catalog as supervised step children on the card:
# a synthetic store at the ensemble kernels' main width (4 chunks of 16
# batches), dense_l1_range (16 tied members, ratio 4, the sweep's default
# kernel path train_step_tiled), a checkpoint set every chunk and an
# 8-step trace window, eval on 2,048 rows, the catalog. (a) runs alone;
# (c) runs beside (b)'s two killed runs, never beside a measured wall.
PIPE_CHUNKS, PIPE_CHUNK_ROWS = 4, 16 * BATCH
PIPE_STEPS = PIPE_CHUNKS * PIPE_CHUNK_ROWS // BATCH
PIPE_PROFILE_STEPS, PIPE_EVAL_ROWS = 8, 2048
PIPE_STEP_NAMES = ("harvest", "sweep", "eval", "catalog")
PIPE_MEMBERS = 16  # dense_l1_range's grid (DEFAULT_L1_RANGE)
PIPE_STALE_S = 300.0  # (a), (b): a live child's heartbeat window
PIPE_HANG_S = 2.0  # (c): the hung step's window
PIPE_BUDGET_S = 90.0
# the dicts' FVU and L0 recomputed in this process vs the eval step's
RTOL_PIPE_EVAL = 1e-4


def pipeline_config(root: Path) -> dict:
    """Phase 18's pipeline under ``root``."""
    chunks = str(root / "chunks")
    return {
        "harvest": {"mode": "synthetic", "dataset_folder": chunks,
                    "seed": SEED + 18, "activation_dim": D,
                    "n_ground_truth_features": N_FEATS,
                    "dataset_size": PIPE_CHUNKS * PIPE_CHUNK_ROWS,
                    "n_chunks": PIPE_CHUNKS, "batch_rows": 8192,
                    "dtype": "float16"},
        "sweep": {"experiment": "dense_l1_range", "log_every": 16,
                  "ensemble": {"output_folder": str(root / "sweep"),
                               "dataset_folder": chunks,
                               "batch_size": BATCH,
                               "learned_dict_ratio": float(RATIO),
                               "n_chunks": PIPE_CHUNKS, "seed": SEED,
                               "checkpoint_every_chunks": 1,
                               "tied_ae": True,
                               "profile_steps": PIPE_PROFILE_STEPS}},
        "eval": {"output_folder": str(root / "eval"),
                 "n_eval_rows": PIPE_EVAL_ROWS, "seed": SEED},
        "catalog": {"output_folder": str(root / "catalog")},
    }


def pipe_artifacts(root: Path) -> dict[str, bytes]:
    """Every durable output (b) must reproduce bitwise: the chunks and
    their meta, the last checkpoint set, the final dicts, eval.json, the
    catalog's files."""
    out = {}
    for rel in ("chunks", "sweep/ckpt", "sweep/final", "eval", "catalog"):
        for f in sorted((root / rel).rglob("*")):
            if f.is_file() and "fsck" not in f.relative_to(root).parts:
                out[str(f.relative_to(root))] = f.read_bytes()
    return out


def pipe_events(run: Path) -> list[dict]:
    return read_events(run / "obs")


def pipe_checks(run: Path, journal, label: str, held=None) -> None:
    """No attempt degraded (``journal``: the run's RunJournal); every step
    span resolved the card, and each step in ``held`` (default: every
    step) held memory there."""
    degraded = [r for r in journal.records()
                if r["event"] == "step.spawn" and r["detail"]["degraded"]]
    if degraded:
        raise AssertionError(f"{label}: degraded attempts {degraded}")
    devices = {ev.get("step"): (ev.get("device"), ev.get("card_peak_bytes"))
               for ev in pipe_events(run)
               if str(ev.get("span", "")).startswith("step.")}
    held = set(devices if held is None else held)
    if not devices or not held <= set(devices) or not all(
            dev == "cuda" and (step not in held or (peak and peak > 0))
            for step, (dev, peak) in devices.items()):
        raise AssertionError(f"{label}: step spans' devices and card "
                             f"bytes {devices}")


def report_launches(report: dict) -> dict:
    """Each kernel's launches from a run report's ``kernel.launches``
    counters (the step children's)."""
    return {k.split("kernel=")[1].rstrip("}"): v
            for k, v in report["counters"].items()
            if k.startswith("kernel.launches{")}


def pipe_trace(trace_dir: Path) -> dict:
    """(e): the sweep's trace names the kernels in its device events."""
    events = json.loads((trace_dir / "trace.json").read_text())
    events = events.get("traceEvents", events)
    kernels = sorted({ev.get("name", "") for ev in events
                      if ev.get("cat") == "kernel"})
    table = json.loads((trace_dir / "kernels.json").read_text())
    # the tied family's kernels: the fp32 GEMM template, the norm and
    # sum passes, the loss, the Adam epilogue
    want = ("sgemm_kernel", "row_norms_kernel", "sums_kernel",
            "loss_part_kernel", "adam_vjp_kernel")
    missing = [w for w in want if not any(w in k for k in kernels)]
    if missing:
        raise AssertionError(f"(e) trace lacks {missing}: {kernels[:20]}")
    return {"device_kernels": len(kernels), "names": [
        k for k in kernels if any(w in k for w in want)][:12],
        "kernels_table": len(table)}


def pipe_eval_reference(root: Path) -> dict:
    """The eval step's numbers recomputed here on two dicts: the same
    rows, the port's metrics on the card."""
    from sparse_coding_tpu_torch.data.chunk_store import ChunkStore
    from sparse_coding_tpu_torch.metrics.core import (
        fraction_variance_unexplained,
        mean_l0,
    )
    from sparse_coding_tpu_torch.utils.artifacts import load_learned_dicts

    ev = json.loads((root / "eval" / "eval.json").read_text())
    recs = ev["dicts"]
    if len(recs) != PIPE_MEMBERS or not all(
            math.isfinite(r["fvu"]) and math.isfinite(r["l0"])
            for r in recs):
        raise AssertionError(f"eval.json: {recs}")
    if not recs[0]["l0"] > recs[-1]["l0"]:
        raise AssertionError(f"eval.json: l0 does not fall over the L1 "
                             f"grid ({recs[0]['l0']} -> {recs[-1]['l0']})")
    chunk = ChunkStore(root / "chunks").load_chunk(0)
    rows = np.random.default_rng(SEED).permutation(
        chunk.shape[0])[:PIPE_EVAL_ROWS]
    x = torch.as_tensor(np.asarray(chunk[rows], np.float32)).to(DEV)
    pairs = load_learned_dicts(root / "sweep" / "final"
                               / "dense_l1_range_learned_dicts.pkl",
                               device=DEV)
    worst = 0.0
    for i in (0, len(pairs) - 1):
        ld = pairs[i][0]
        for key, fn in (("fvu", fraction_variance_unexplained),
                        ("l0", mean_l0)):
            got, want = float(fn(ld, x)), recs[i][key]
            err = abs(got - want) / max(abs(want), 1e-12)
            worst = max(worst, err)
            if err > RTOL_PIPE_EVAL:
                raise AssertionError(f"eval.json {key}[{i}] {want} vs "
                                     f"{got} here")
    return {"fvu": [recs[0]["fvu"], recs[-1]["fvu"]],
            "l0": [recs[0]["l0"], recs[-1]["l0"]], "max_rel_err": worst}


def pipe_hung(tmp: Path, out: dict) -> None:
    """(c): a fake step that never beats; the watchdog probes the card
    (from a process of its own) and halts. Runs beside (b)'s killed
    runs; its result or error lands in ``out``."""
    from sparse_coding_tpu_torch.pipeline import Step, StepHung, Supervisor
    from sparse_coding_tpu_torch.resilience import watchdog

    try:
        hang = Step("hang", [sys.executable, "-c",
                             "import time; time.sleep(300)"],
                    done=lambda: False)
        sup = Supervisor(tmp / "pipe_c", [hang], max_attempts=2,
                         heartbeat_stale_s=PIPE_HANG_S, poll_s=0.1)
        t0 = time.perf_counter()
        try:
            sup.run()
        except StepHung as e:
            diag = e.diagnosis
        else:
            raise AssertionError("(c) the hung step was not halted")
        hung = [r for r in sup.journal.records()
                if r["event"] == "step.hung"]
        probe = diag["probe"]
        if (len(hung) != 1 or hung[0]["detail"]["probe"] != probe
                or not probe["configured"] or not probe["reachable"]
                or hung[0]["detail"]["action"] != watchdog.HALT
                or watchdog.classify_hang(probe) != watchdog.HALT):
            raise AssertionError(f"(c) journal {hung}, diagnosis {diag}")
        out["c"] = {"probe": probe, "action": diag["action"],
                    "wall_s": time.perf_counter() - t0,
                    "spawns": sum(r["event"] == "step.spawn"
                                  for r in sup.journal.records())}
    except BaseException as e:  # handed to the main thread, re-raised there
        out["c_error"] = e


def pipe_kills(run: Path, cfg: dict) -> None:
    """(b)'s two killed runs: a supervisor whose sweep child is SIGKILLed
    at its second ``sweep.chunk`` barrier, then a fresh one whose eval
    child is SIGKILLed at ``eval.write`` (each ``max_attempts=1``)."""
    from sparse_coding_tpu_torch.pipeline import (
        StepFailed,
        Supervisor,
        build_pipeline,
    )
    from sparse_coding_tpu_torch.resilience import crash

    for plan, step in (({"sweep": "sweep.chunk:nth=2"}, "sweep"),
                       ({"eval": "eval.write:nth=1"}, "eval")):
        steps = build_pipeline(run, cfg)
        for s in steps:
            if s.name in plan:
                s.env = {crash.ENV_VAR: plan[s.name]}
        try:
            Supervisor(run, steps, max_attempts=1,
                       heartbeat_stale_s=PIPE_STALE_S).run()
        except StepFailed as e:
            if e.step != step or "killed by signal 9" not in e.reason:
                raise
        else:
            raise AssertionError(f"(b) {plan} did not kill {step}")


def pipeline_phase(tmp: Path) -> dict:
    """Phase 18: (a) the full supervised run, alone; (b) kill and resume,
    with (c) a hung fake step beside (b)'s killed runs; (d) audits; (e)
    the trace."""
    import threading

    from sparse_coding_tpu_torch.fsck.core import run_fsck
    from sparse_coding_tpu_torch.obs import ledger
    from sparse_coding_tpu_torch.obs.report import build_report
    from sparse_coding_tpu_torch.pipeline import (
        PreflightAuditError,
        Supervisor,
        build_pipeline,
    )

    t_phase = time.perf_counter()
    rep: dict = {}
    root_a, root_b = tmp / "pipe_a", tmp / "pipe_b"
    run_a, run_b = root_a / "run", root_b / "run"
    cfg_a, cfg_b = pipeline_config(root_a), pipeline_config(root_b)
    # (a) the full run
    t0 = time.perf_counter()
    sup_a = Supervisor(run_a, build_pipeline(run_a, cfg_a),
                       heartbeat_stale_s=PIPE_STALE_S)
    summary = sup_a.run()
    rep["a_wall_s"] = time.perf_counter() - t0
    if summary != {s: "done" for s in PIPE_STEP_NAMES}:
        raise AssertionError(f"(a) {summary}")
    pipe_checks(run_a, sup_a.journal, "(a)")
    report = build_report(run_a)
    walls = {ev["step"]: ev["dur_s"] for ev in pipe_events(run_a)
             if ev.get("span") == "pipeline.step"}
    child = {name: report["spans"][f"step.{name}"]["total_s"]
             for name in PIPE_STEP_NAMES}
    launches = report_launches(report)
    paths = report["kernel_paths"]
    if set(paths) != {"train_step_tiled"}:
        raise AssertionError(f"(a) kernel paths {paths}")
    for name in TIED_KERNELS:
        if launches.get(name) != PIPE_STEPS:
            raise AssertionError(f"(a) {name} launched {launches.get(name)} "
                                 f"times, want {PIPE_STEPS}: {launches}")
    if any(launches.get(name) for name in UNTIED_KERNELS):
        raise AssertionError(f"(a) untied kernels launched: {launches}")
    if report["preparation"]["nvcc_runs"]:
        raise AssertionError(f"(a) children ran nvcc: {report['preparation']}")
    rep["a"] = {"walls_s": walls, "child_s": child, "launches": launches,
                "kernel_paths": paths, "summary": summary,
                "spans_s": {k: v["total_s"]
                            for k, v in report["spans"].items()}}
    log(f"  (a) {rep['a_wall_s']:.1f} s: "
        + ", ".join(f"{k} {walls[k]:.2f} s (child {child[k]:.2f})"
                    for k in PIPE_STEP_NAMES)
        + f"; each tied kernel {PIPE_STEPS} launches on {list(paths)}; "
        "0 nvcc runs")
    rep["eval"] = pipe_eval_reference(root_a)
    # (e) the trace
    if (report["perf"]["trace_captured"], report["perf"]["trace_skipped"]) \
            != (1, 0):
        raise AssertionError(f"(e) trace captured/skipped {report['perf']}")
    rep["trace"] = pipe_trace(root_a / "sweep" / "trace")
    rep["trace"]["cost_s"] = next(
        {k: ev[k] for k in ("dur_s", "begin_s", "finalize_s")}
        for ev in pipe_events(run_a) if ev.get("kind") == "trace.captured")
    log(f"  (e) trace: {rep['trace']['device_kernels']} device kernel "
        f"names, among them {rep['trace']['names'][:5]}; the capture "
        f"{rep['trace']['cost_s']}")

    # (b) the two killed runs, (c) beside them, then the resume alone
    side: dict = {}
    hung = threading.Thread(target=pipe_hung, args=(tmp, side))
    hung.start()
    try:
        pipe_kills(run_b, cfg_b)
    finally:
        hung.join()
    if "c_error" in side:
        raise side["c_error"]
    rep["c"] = side["c"]
    log(f"  (c) hung step: probe {side['c']['probe']['devices']} "
        f"reachable in {side['c']['probe']['probe_s']:.2f} s "
        f"({side['c']['probe']['detail']}), verdict "
        f"{side['c']['action']}, {side['c']['spawns']} spawn, halted in "
        f"{side['c']['wall_s']:.1f} s")
    t0 = time.perf_counter()
    sup_b = Supervisor(run_b, build_pipeline(run_b, cfg_b),
                       heartbeat_stale_s=PIPE_STALE_S)
    summary_b = sup_b.run()
    rep["resume_wall_s"] = time.perf_counter() - t0
    if summary_b != {"harvest": "skipped", "sweep": "skipped",
                     "eval": "done", "catalog": "done"}:
        raise AssertionError(f"(b) {summary_b}")
    pipe_checks(run_b, sup_b.journal, "(b)")
    got, want = pipe_artifacts(root_b), pipe_artifacts(root_a)
    differ = sorted(k for k in set(got) | set(want)
                    if got.get(k) != want.get(k))
    if differ or not want:
        raise AssertionError(f"(b) not bitwise (a): {differ}")
    events = [(r["event"], r["step"]) for r in sup_b.journal.records()]
    for need in (("step.killed", "sweep"), ("step.killed", "eval"),
                 ("lease.takeover", "sweep"), ("lease.takeover", "eval")):
        if need not in events:
            raise AssertionError(f"(b) journal lacks {need}: {events}")
    preflight = [ev["dur_s"] for ev in pipe_events(run_b)
                 if ev.get("span") == "pipeline.preflight_fsck"]
    if len(preflight) != 2:
        raise AssertionError(f"(b) preflight audits {preflight}")
    rep["b"] = {"files_bitwise": len(want), "preflight_fsck_s": preflight,
                "journal": events}
    log(f"  (b) killed at sweep.chunk (hit 2) and eval.write, two lease "
        f"takeovers, resumed in {rep['resume_wall_s']:.1f} s (preflight "
        f"fsck {', '.join(f'{v:.2f}' for v in preflight)} s): {len(want)} "
        "files bitwise (a)'s")

    # (d) audits
    clean = run_fsck(run_a, write_report=False)
    if not clean.clean:
        raise AssertionError(f"(d) fsck of (a)'s tree: {clean.findings}")
    rows = ledger.read_rows(run_a / ledger.LEDGER_NAME)
    if [r["kind"] for r in rows] != ["run"] or not rows[0]["paths"]:
        raise AssertionError(f"(d) perf ledger rows {rows}")
    chunk = root_b / "chunks" / "1.npy"
    raw = bytearray(chunk.read_bytes())
    raw[-1] ^= 0x01
    chunk.write_bytes(bytes(raw))
    rot = run_fsck(run_b, write_report=False)
    fatal = [(f.kind, f.path) for f in rot.fatal]
    if fatal != [("INCONSISTENT", str(chunk.resolve()))]:
        raise AssertionError(f"(d) flipped chunk byte: {rot.findings}")
    try:
        Supervisor(run_b, build_pipeline(run_b, cfg_b),
                   heartbeat_stale_s=PIPE_STALE_S).run()
    except PreflightAuditError as e:
        if [f.path for f in e.findings] != [str(chunk.resolve())]:
            raise
    else:
        raise AssertionError("(d) the preflight admitted a rotted tree")
    rep["d"] = {"fsck_clean": True, "ledger_rows": len(rows),
                "rot_fatal": fatal}
    log(f"  (d) fsck of (a)'s tree clean; one flipped chunk byte: "
        f"{fatal[0][0]} (fatal), the preflight halts typed; "
        f"{len(rows)} perf-ledger row")
    rep["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 18: {rep['wall_s']:.1f} s (budget {PIPE_BUDGET_S:.0f} s)")
    return rep


# -- phase 19: Group-SAE and the fleet (groups/, pipeline/fleet.py, plane) --

# a 4-layer synthetic multi-tap store at the ensemble kernels' main width
# (the pipeline's LM mode is tiny_test_config in both packages, so this is
# the widest real shape the path takes): 2 chunks of 16 batches a layer,
# the JAX harvest's per-layer mix at phase_step 0.35; the group step
# assigns G = 2 pools of 2 layers, 4 chunks each. Each group tenant trains
# dense_l1_range (16 tied members, ratio 4, batch 2048, a checkpoint set a
# chunk) over its pool — 64 steps — then evaluates on 2,048 rows.
FLEET_LAYERS, FLEET_LAYER_CHUNKS, FLEET_PHASE_STEP = (0, 1, 2, 3), 2, 0.35
FLEET_GROUPS = [[0, 1], [2, 3]]
FLEET_STEPS = 2 * FLEET_LAYER_CHUNKS * PIPE_CHUNK_ROWS // BATCH
FLEET_SAMPLE_ROWS = 2048
FLEET_POISON = {"SPARSE_CODING_FAULT_PLAN":
                "sweep.anomaly:nth=1,count=0,mode=nan"}
FLEET_WALL_S = 300.0  # the schedulers' own bound on a drain
FLEET_BUDGET_S = 120.0
# (c): the plane's pod — one slice a replica, serving 1-2 replicas, the
# fleet the rest; 12 held requests of 8 rows raise the queue past
# up_queued_rows
TIDE_PLANE = dict(n_slices=2, replica_slices=1, min_replicas=1,
                  max_replicas=2, up_queued_rows=4.0, down_queued_rows=2.0,
                  hold_ticks=2)
TIDE_REQUESTS, TIDE_ROWS = 12, 8
TIDE_TICK_S = 0.05


def fleet_group_config(root: Path) -> dict:
    """(a)'s group DAG config under ``root``."""
    return {
        "harvest": {"mode": "synthetic",
                    "dataset_folder": str(root / "store"),
                    "layers": list(FLEET_LAYERS), "seed": SEED + 19,
                    "activation_dim": D, "n_ground_truth_features": N_FEATS,
                    "dataset_size": FLEET_LAYER_CHUNKS * PIPE_CHUNK_ROWS,
                    "n_chunks": FLEET_LAYER_CHUNKS, "batch_rows": 8192,
                    "dtype": "float16", "phase_step": FLEET_PHASE_STEP},
        "group": {"n_groups": len(FLEET_GROUPS), "n_sample_chunks": 1,
                  "n_sample_rows": FLEET_SAMPLE_ROWS, "seed": SEED},
    }


def fleet_tenant_base() -> dict:
    """The group tenants' sweep and eval (groups/tenants.py fills in the
    pool, the chunk count and the output dirs)."""
    return {"sweep": {"experiment": "dense_l1_range", "log_every": 16,
                      "ensemble": {"batch_size": BATCH,
                                   "learned_dict_ratio": float(RATIO),
                                   "seed": SEED, "tied_ae": True,
                                   "checkpoint_every_chunks": 1,
                                   # the poisoned tenant rolls back once,
                                   # then halts typed
                                   "guardian_rollback_budget": 1}},
            "eval": {"n_eval_rows": PIPE_EVAL_ROWS, "seed": SEED}}


def group_files(store: Path) -> dict[str, bytes]:
    """Every file the group step writes: the marker, the similarity
    matrix and the pooled manifests."""
    out = {"groups.json": (store / "groups.json").read_bytes(),
           "similarity.npy": (store / "similarity.npy").read_bytes()}
    for g in range(len(FLEET_GROUPS)):
        rel = f"group-{g:03d}/manifest.json"
        out[rel] = (store / rel).read_bytes()
    return out


def child_starts(run: Path) -> dict[str, float]:
    """Each step's start and exit cost: the supervisor's ``pipeline.step``
    wall less the child's own ``step.<name>`` span."""
    events = read_events(run / "obs")
    walls = {ev["step"]: ev["dur_s"] for ev in events
             if ev.get("span") == "pipeline.step"}
    work = {ev["span"][len("step."):]: ev["dur_s"] for ev in events
            if str(ev.get("span", "")).startswith("step.")}
    return {k: walls[k] - work.get(k, 0.0) for k in walls}


def fleet_dag(tmp: Path) -> dict:
    """(a): the group DAG under a supervisor on the card; the assignment;
    similarity.npy bitwise a host pass over the same store; a rebuild
    rewrites every group file byte for byte; a resumed supervisor skips
    every step."""
    from sparse_coding_tpu_torch.groups import (
        build_groups,
        layer_similarity,
        load_groups,
    )
    from sparse_coding_tpu_torch.pipeline import (
        Supervisor,
        build_group_pipeline,
    )

    cfg = fleet_group_config(tmp / "groups")
    store = Path(cfg["harvest"]["dataset_folder"])
    run = tmp / "groups" / "run"
    t0 = time.perf_counter()
    sup = Supervisor(run, build_group_pipeline(run, cfg),
                     heartbeat_stale_s=PIPE_STALE_S)
    summary = sup.run()
    wall = time.perf_counter() - t0
    names = [f"harvest-{i}" for i in range(len(FLEET_LAYERS))] + [
        "manifest", "scrub", "group"]
    if summary != {n: "done" for n in names}:
        raise AssertionError(f"(a) {summary}")
    # the writers make their rows on the card; manifest, scrub and group
    # are host work and hold nothing there
    pipe_checks(run, sup.journal, "(a)", held=[
        n for n in names if n.startswith("harvest")])
    payload = load_groups(store)
    got = [g["layers"] for g in payload["groups"]]
    if got != FLEET_GROUPS:
        raise AssertionError(f"(a) assignment {got}, want {FLEET_GROUPS}")
    files = group_files(store)
    gcfg = cfg["group"]
    sim = layer_similarity(store, n_sample_chunks=gcfg["n_sample_chunks"],
                           n_sample_rows=gcfg["n_sample_rows"],
                           seed=gcfg["seed"])
    if np.load(store / "similarity.npy").tobytes() != \
            sim["matrix"].tobytes():
        raise AssertionError("(a) similarity.npy is not the host pass's")
    t1 = time.perf_counter()
    build_groups(store, n_groups=gcfg["n_groups"],
                 n_sample_chunks=gcfg["n_sample_chunks"],
                 n_sample_rows=gcfg["n_sample_rows"], seed=gcfg["seed"])
    rebuild_s = time.perf_counter() - t1
    if group_files(store) != files:
        raise AssertionError("(a) a rebuild changed the group files")
    t1 = time.perf_counter()
    again = Supervisor(run, build_group_pipeline(run, cfg),
                       heartbeat_stale_s=PIPE_STALE_S).run()
    resume_s = time.perf_counter() - t1
    if again != {n: "skipped" for n in names}:
        raise AssertionError(f"(a) resume {again}")
    starts = child_starts(run)
    rep = {"wall_s": wall, "rebuild_s": rebuild_s, "resume_s": resume_s,
           "assignment": got, "similarity": sim["matrix"].tolist(),
           "child_start_s": starts, "store": str(store)}
    log(f"  (a) group DAG {wall:.1f} s ({len(names)} step children, start "
        f"and exit {min(starts.values()):.2f}-{max(starts.values()):.2f} s "
        f"each): G={len(got)} {got}; similarity row 0 "
        + ", ".join(f"{v:.4f}" for v in sim["matrix"][0])
        + f", bitwise the host pass; rebuild {rebuild_s:.2f} s byte for "
        f"byte; resume skipped all in {resume_s:.2f} s")
    return rep


def fleet_run_report(run: Path, label: str) -> dict:
    """A tenant's run: no degraded attempt, its step spans on the card,
    no nvcc run and no CUDA-graph capture; its report."""
    from sparse_coding_tpu_torch.obs.report import build_report
    from sparse_coding_tpu_torch.pipeline.journal import RunJournal

    pipe_checks(run, RunJournal(run / "journal.jsonl"), label)
    report = build_report(run)
    prep = report["preparation"]
    if prep["nvcc_runs"] or prep["captures"]:
        raise AssertionError(f"{label}: preparation {prep}")
    return report


def fleet_tenants(tmp: Path, store: Path) -> dict:
    """(b): one tenant per group, group-000 poisoned; the halt contained,
    group-001 bitwise a standalone run of its config; each tied kernel
    once a step in group-001's sweep child; the fleet report; fsck. The
    standalone sweep runs in this process as the fleet starts, so it
    trains while every tenant's and the scavenger's children still import
    torch: its chunks are the card's alone (``alone_overlap`` checks)."""
    import copy
    import threading

    from sparse_coding_tpu_torch import obs
    from sparse_coding_tpu_torch.fsck.core import run_fsck
    from sparse_coding_tpu_torch.groups import enqueue_group_tenants
    from sparse_coding_tpu_torch.obs.report import build_fleet_report
    from sparse_coding_tpu_torch.pipeline import FleetScheduler
    from sparse_coding_tpu_torch.pipeline.steps import run_eval, run_sweep

    fleet_dir, out_root = tmp / "fleet", tmp / "tenants"
    sched = FleetScheduler(fleet_dir, n_slices=2, max_concurrent=2,
                           max_run_attempts=1, poll_s=0.1,
                           heartbeat_stale_s=PIPE_STALE_S,
                           max_wall_s=FLEET_WALL_S)
    names = enqueue_group_tenants(sched, store, fleet_tenant_base(),
                                  out_root, max_attempts=1,
                                  env_overrides={"group-000": FLEET_POISON})
    # the same config alone, in this process, on the card (a tenant's
    # pipeline.json is its queue spec's config)
    cfg = sched.queue.replay().specs["group-001"]["config"]
    alone = copy.deepcopy(cfg)
    alone["sweep"]["ensemble"]["output_folder"] = str(tmp / "alone" / "sweep")
    alone["eval"]["output_folder"] = str(tmp / "alone" / "eval")
    fleet: dict = {}

    def drive():
        try:
            fleet["summary"] = sched.run()
        except BaseException as e:  # handed to this thread below
            fleet["error"] = e

    t0 = time.perf_counter()
    thread = threading.Thread(target=drive, name="phase19-fleet")
    thread.start()
    sink = obs.EventSink(tmp / "alone" / "obs" / "events.jsonl")
    prev_sink = obs.configure_sink(sink)
    try:
        t1 = time.perf_counter()
        run_sweep(alone)
        sync()
        alone_sweep_s = time.perf_counter() - t1
    finally:
        obs.configure_sink(prev_sink)
        sink.close()
        thread.join()
    wall = time.perf_counter() - t0
    if "error" in fleet:
        raise fleet["error"]
    summary = fleet["summary"]
    if summary != {"group-000": "halted", "group-001": "done"}:
        raise AssertionError(f"(b) {summary} ({names})")
    runs = {n: fleet_dir / "runs" / n for n in names}
    if json.loads((runs["group-001"] / "pipeline.json").read_text()) != cfg:
        raise AssertionError("(b) group-001's pipeline.json is not its spec")
    reports = {n: fleet_run_report(runs[n], f"(b) {n}") for n in names}
    halted = json.loads((out_root / "group-000" / "sweep"
                         / "guardian.json").read_text())
    if "halt" not in halted or (out_root / "group-000" / "sweep"
                                / "final").exists():
        raise AssertionError("(b) group-000's halt is not in its own run")
    launches = report_launches(reports["group-001"])
    for name in TIED_KERNELS:
        if launches.get(name) != FLEET_STEPS:
            raise AssertionError(f"(b) {name} launched {launches.get(name)} "
                                 f"times, want {FLEET_STEPS}: {launches}")
    if any(launches.get(name) for name in UNTIED_KERNELS):
        raise AssertionError(f"(b) untied kernels launched: {launches}")
    if set(reports["group-001"]["kernel_paths"]) != {"train_step_tiled"}:
        raise AssertionError(f"(b) kernel paths "
                             f"{reports['group-001']['kernel_paths']}")
    t1 = time.perf_counter()
    run_eval(alone)
    alone_s = alone_sweep_s + time.perf_counter() - t1
    tenant = fleet_outputs(out_root / "group-001")
    if fleet_outputs(tmp / "alone") != tenant:
        raise AssertionError("(b) group-001 is not bitwise its standalone "
                             "run")
    frep = build_fleet_report(fleet_dir)
    sched_c = frep["scheduler"]
    if (frep["states"] != summary or sched_c["halts"] != 1
            or sched_c["releases"] != {"done": 1, "halted": 1}
            or sched_c["placements"] != 2):
        raise AssertionError(f"(b) fleet report {frep['states']} "
                             f"{sched_c}")
    fsck = {}
    for label, root in (("fleet", fleet_dir), ("store", store)):
        found = run_fsck(root, write_report=False)
        if found.fatal:
            raise AssertionError(f"(b) fsck of the {label}: {found.fatal}")
        fsck[label] = len(found.findings)
    acts = {n: sweep_numbers(read_events(runs[n] / "obs"))["acts_per_s"]
            for n in ("group-001",)}
    alone_events = read_events(tmp / "alone" / "obs")
    starts = {n: child_starts(runs[n]) for n in names}
    walls = {n: {ev["step"]: ev["dur_s"] for ev in read_events(runs[n] / "obs")
                 if ev.get("span") == "pipeline.step"} for n in names}
    rep = {"wall_s": wall, "summary": summary, "launches": launches,
           "standalone_s": alone_s, "standalone_sweep_s": alone_sweep_s,
           "standalone_acts_per_s": sweep_numbers(alone_events)["acts_per_s"],
           "standalone_chunks": span_windows(alone_events, "sweep.chunk"),
           "acts_per_s": acts,
           "child_start_s": starts, "step_walls_s": walls,
           "fsck_findings": fsck, "final": tenant,
           "guardian_halt": halted["halt"]}
    log(f"  (b) two tenants side by side in {wall:.1f} s: {summary}; "
        f"group-001's sweep child launched each tied kernel {FLEET_STEPS} "
        f"times ({acts['group-001']:,.0f} acts/s over its chunks after the "
        f"first), 0 nvcc runs and 0 captures in every tenant, every step "
        f"on cuda; its dicts and eval.json bitwise the standalone run "
        f"({alone_s:.1f} s in process, its sweep "
        f"{rep['standalone_acts_per_s']:,.0f} acts/s as the fleet started); "
        f"fleet report: 2 placements, "
        f"1 halt; fsck fleet {fsck['fleet']} finding(s), store "
        f"{fsck['store']}, none fatal")
    return rep


def span_windows(events: list[dict], prefix: str) -> list[list[float]]:
    """[start, end] on the wall clock of each span whose name starts with
    ``prefix`` (a span's event is stamped at its end)."""
    return [[ev["ts"] - ev["dur_s"], ev["ts"]] for ev in events
            if str(ev.get("span", "")).startswith(prefix)]


def alone_overlap(windows: list, roots: list[Path]) -> float:
    """Seconds of ``windows`` during which a step child under one of the
    fleet dirs ``roots`` was inside its ``step.*`` span (its device work
    lies there)."""
    others = [w for root in roots for run in sorted((root / "runs").iterdir())
              for w in span_windows(read_events(run / "obs"), "step.")]
    return sum(max(0.0, min(a[1], b[1]) - max(a[0], b[0]))
               for a in windows for b in others)


def fleet_outputs(root: Path) -> dict[str, bytes]:
    """A tenant's final dicts and eval.json."""
    final = root / "sweep" / "final" / "dense_l1_range_learned_dicts.pkl"
    return {"final": final.read_bytes(),
            "eval": (root / "eval" / "eval.json").read_bytes()}


def wait_for(predicate, what: str, stop, timeout_s: float = 180.0) -> float:
    """Seconds until ``predicate()``; raises at the timeout or once
    ``stop`` (a threading.Event) is set."""
    t0 = time.perf_counter()
    while not predicate():
        if stop.is_set():
            raise AssertionError(f"(c) stopped while waiting for {what}")
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"(c) {what} never happened")
        time.sleep(0.02)
    return time.perf_counter() - t0


def fleet_tide(tmp: Path, dict_file: Path, ready, stop) -> dict:
    """(c): the elastic plane over a fleet of its own (run beside (b)) and
    a 1-active/1-spare gateway on phase 17's registry, warmed while (a)
    runs. Once ``ready`` is set (groups.json is durable) a scavenger copy
    of group-001 is preempted at a checkpoint by the scale-up, the spare
    activates with 0 captures, the scale-down drains then releases the
    replica, the scavenger resumes and finishes (its outputs are returned
    under ``final`` for the bitwise check against (b)'s group-001); a
    fresh arbiter reconciles recorded splits. ``stop`` aborts: the
    scheduler's drain then kills its workers on the way out."""
    import threading

    from sparse_coding_tpu_torch import obs, xcache
    from sparse_coding_tpu_torch.groups import (
        group_tenant_config,
        load_groups,
    )
    from sparse_coding_tpu_torch.obs.report import build_fleet_report
    from sparse_coding_tpu_torch.pipeline import (
        ElasticPlane,
        FleetScheduler,
        PlaneConfig,
    )
    from sparse_coding_tpu_torch.pipeline.journal import RunJournal
    from sparse_coding_tpu_torch.pipeline.plane import REBALANCE_EVENT
    from sparse_coding_tpu_torch.serve import INTERACTIVE, ServingGateway

    fleet_dir, scav_root = tmp / "tide_fleet", tmp / "scav"
    xcache.enable(tmp / "tide_xcache")
    t_setup = time.perf_counter()
    reg, _ = serve_registry(dict_file, DEV)
    gw = ServingGateway(reg, n_replicas=1, n_spares=1, buckets=(TIDE_ROWS,),
                        ops=("encode",), max_wait_ms=0.5, device=DEV)
    sched, thread, result = None, None, {}
    try:
        c0 = serve_captures()
        gw.warmup()
        warm = serve_captures() - c0
        setup_s = time.perf_counter() - t_setup
        wait_for(ready.is_set, "the group assignment", stop,
                 timeout_s=FLEET_WALL_S)
        store = tmp / "groups" / "store"
        group = load_groups(store)["groups"][1]
        sched = FleetScheduler(fleet_dir, n_slices=1, max_concurrent=1,
                               max_run_attempts=1, poll_s=0.1,
                               heartbeat_stale_s=PIPE_STALE_S,
                               max_wall_s=FLEET_WALL_S)
        sched.enqueue("scav", group_tenant_config(
            fleet_tenant_base(), group, store, scav_root), kind="group",
            priority="scavenger", max_attempts=1)
        cfg = PlaneConfig(**TIDE_PLANE)
        plane = ElasticPlane(fleet_dir, cfg, gateway=gw, fleet=sched)
        plane.reconcile()
        if sched.n_slices != 1:
            raise AssertionError(f"(c) base split gave the fleet "
                                 f"{sched.n_slices} slices")

        def drive():
            try:
                result["summary"] = sched.run()
            except BaseException as e:  # handed to fleet_tide below
                result["error"] = e

        t0 = time.perf_counter()
        thread = threading.Thread(target=drive, name="phase19-tide-fleet")
        thread.start()
        sweep_out = scav_root / group["name"] / "sweep"
        to_ckpt = wait_for((sweep_out / "ckpt").exists,
                           "the scavenger's first checkpoint set", stop)
        # the tide rises: hold the dispatcher, pile up queue depth
        rs = np.random.default_rng(SEED + 19)
        d = reg.get("mlp2/0").d_activation
        xs = [rs.standard_normal((TIDE_ROWS, d)).astype(np.float32)
              for _ in range(TIDE_REQUESTS)]
        gw.pause()
        futs = [gw.submit("mlp2/0", x, priority=INTERACTIVE) for x in xs]
        c1 = serve_captures()
        t_up = time.perf_counter()
        first, second = plane.tick(), plane.tick()
        up_s = time.perf_counter() - t_up
        if first["rebalanced"] or not second["rebalanced"] or \
                second["replicas"] != 2:
            raise AssertionError(f"(c) scale-up ticks {first} {second}")
        if gw.active_replica_names() != ["replica-0", "spare-0"]:
            raise AssertionError(f"(c) actives {gw.active_replica_names()}")
        spare_captures = serve_captures() - c1
        gw.resume()
        answers = [f.result(timeout=60) for f in futs]
        if spare_captures:
            raise AssertionError(f"(c) the spare captured {spare_captures} "
                                 "programs")
        # the record was durable before the reclaim, and the scavenger
        # leaves through its checkpoint path
        seqs = [(r["seq"], r["event"])
                for r in sched.queue.journal.records()]
        rec_seq = next(q for q, e in seqs if e == REBALANCE_EVENT)
        pre_seq = next(q for q, e in seqs if e == "run.preempt")
        if not rec_seq < pre_seq:
            raise AssertionError("(c) the reclaim came before the rebalance "
                                 "record")
        to_release = wait_for(
            lambda: ("scav", "preempted") in [
                (r["step"], r["detail"].get("outcome"))
                for r in sched.queue.journal.records()
                if r["event"] == "run.release"],
            "the scavenger's preempted release", stop)
        journal = RunJournal(fleet_dir / "runs" / "scav"
                             / "journal.jsonl").records()
        if not any(r["event"] == "step.preempted" and r["step"] == "sweep"
                   for r in journal) or any(r["event"] == "step.killed"
                                            for r in journal):
            raise AssertionError("(c) the scavenger was not preempted at a "
                                 "checkpoint")
        if (sweep_out / "final").exists():
            raise AssertionError("(c) the scavenger finished before its "
                                 "preemption")
        # the tide ebbs: the queue is empty, the depth decays, the plane
        # drains a replica and hands its slice back
        t_down, ticks = time.perf_counter(), 0
        while plane.split().serve_slices != 1:
            if ticks > 400 or stop.is_set():
                raise AssertionError("(c) the plane never scaled down")
            plane.tick()
            ticks += 1
            time.sleep(TIDE_TICK_S)
        down_s = time.perf_counter() - t_down
        states = {n: gw.replica(n).state for n in gw.replica_names()}
        if sorted(states.values()) != ["active", "draining"] or \
                sched.n_slices != 1:
            raise AssertionError(f"(c) after scale-down {states}, fleet "
                                 f"{sched.n_slices}")
        plane.tick()  # the drain window passes
        states = {n: gw.replica(n).state for n in gw.replica_names()}
        if sorted(states.values()) != ["active", "spare"]:
            raise AssertionError(f"(c) not released: {states}")
        wait_for(lambda: not thread.is_alive(), "the scavenger's end", stop,
                 timeout_s=FLEET_WALL_S)
        tide_s = time.perf_counter() - t0
        if "error" in result:
            raise result["error"]
        if result.get("summary") != {"scav": "done"}:
            raise AssertionError(f"(c) {result}")
        report = fleet_run_report(fleet_dir / "runs" / "scav", "(c) scav")
        again = [gw.query("mlp2/0", x, priority=INTERACTIVE) for x in xs]
        if not all(torch.equal(torch.as_tensor(a).cpu(),
                               torch.as_tensor(b).cpu())
                   for a, b in zip(answers, again)):
            raise AssertionError("(c) the answers during the tide differ "
                                 "from the same requests after it")
        # a fresh arbiter over records an arbiter killed at its barrier
        # left behind: up, then down
        recon = {}
        for serve, reason in ((2, "up"), (1, "down")):
            sched.queue.append(REBALANCE_EVENT, serve_slices=serve,
                               fleet_slices=cfg.n_slices - serve,
                               reason=reason)
            c2 = serve_captures()
            fresh = ElasticPlane(fleet_dir, cfg, gateway=gw, fleet=sched)
            split = fresh.reconcile()
            got = (split.serve_slices, sched.n_slices,
                   len(gw.active_replica_names()))
            if got != (serve, cfg.n_slices - serve, serve) or \
                    serve_captures() != c2:
                raise AssertionError(f"(c) reconcile {reason}: {got}")
            recon[reason] = got
        # the arbiters count into the process registry, as the JAX
        # package's do; its plane.* entries go to the fleet's obs dir
        snap = obs.get_registry().snapshot()
        sink = obs.EventSink(fleet_dir / "obs" / f"plane-{os.getpid()}.jsonl")
        obs.emit_event("metrics", sink=sink, registry={
            kind: {k: v for k, v in table.items() if k.startswith("plane.")}
            for kind, table in snap.items()})
        sink.close()
        frep = build_fleet_report(fleet_dir)
        pl = frep["plane"]
        if ([r["reason"] for r in pl["records"]] != ["up", "down", "up",
                                                     "down"]
                or (pl["rebalances"], pl["scale_ups"], pl["scale_downs"])
                != (2, 1, 1) or pl["reconciles"] != 3
                or pl["replicas_released"] != 1
                or frep["states"] != {"scav": "done"}
                or frep["scheduler"]["preemptions"] != 1):
            raise AssertionError(f"(c) fleet report plane {pl}, states "
                                 f"{frep['states']}")
        events = read_events(fleet_dir / "runs" / "scav" / "obs")
        rep = {"wall_s": tide_s, "setup_s": setup_s,
               "warmup_captures": warm, "to_first_ckpt_s": to_ckpt,
               "scale_up_ticks_s": up_s, "to_preempted_release_s": to_release,
               "scale_down_s": down_s, "scale_down_ticks": ticks,
               "spare_captures": spare_captures, "reconcile": recon,
               "child_start_s": child_starts(fleet_dir / "runs" / "scav"),
               "acts_per_s": sweep_numbers(events)["acts_per_s"],
               "launches": report_launches(report),
               "plane": {k: v for k, v in pl.items() if k != "records"},
               "final": fleet_outputs(scav_root / group["name"])}
        log(f"  (c) tide {tide_s:.1f} s beside (b) (gateway set up in "
            f"{setup_s:.1f} s during (a), {warm} captures): the scavenger's "
            f"first checkpoint set after {to_ckpt:.1f} s; two ticks "
            f"({up_s * 1e3:.1f} ms) recorded the scale-up, reclaimed the "
            f"fleet, activated the spare with 0 captures, "
            f"{TIDE_REQUESTS} held requests answered; the scavenger "
            f"checkpointed out in {to_release:.1f} s; scale-down in {ticks} "
            f"ticks ({down_s:.2f} s), drained then released; a fresh "
            f"arbiter reconciled {recon}")
        return rep
    finally:
        if thread is not None and thread.is_alive():
            sched.max_wall_s = 0.0  # its drain ends, killing its workers
            thread.join(timeout=FLEET_WALL_S)
        gw.shutdown()
        xcache.disable()


def fleet_phase(tmp: Path, dict_file: Path) -> dict:
    """Phase 19: (a) the group DAG; then (b) the fleet of group tenants in
    this thread and (c) the plane's tide beside it (its gateway warmed
    during (a)); (c)'s scavenger must end with (b)'s group-001 bits."""
    import threading

    t_phase = time.perf_counter()
    ready, stop, side = threading.Event(), threading.Event(), {}

    def tide():
        try:
            side["c"] = fleet_tide(tmp, dict_file, ready, stop)
        except BaseException as e:  # handed to this thread below
            side["error"] = e

    thread = threading.Thread(target=tide, name="phase19-tide")
    thread.start()
    try:
        rep = {"a": fleet_dag(tmp)}
        ready.set()
        rep["b"] = fleet_tenants(tmp, Path(rep["a"]["store"]))
    except BaseException:
        stop.set()
        raise
    finally:
        ready.set()
        thread.join()
    if "error" in side:
        raise side["error"]
    rep["c"] = side["c"]
    if rep["c"].pop("final") != rep["b"].pop("final"):
        raise AssertionError("(c) the resumed scavenger is not bitwise (b)'s "
                             "group-001")
    rep["wall_s"] = time.perf_counter() - t_phase
    overlap = alone_overlap(rep["b"].pop("standalone_chunks"),
                            [tmp / "fleet", tmp / "tide_fleet"])
    rep["b"]["standalone_overlap_s"] = overlap
    log(f"  (b)'s standalone sweep: {rep['b']['standalone_acts_per_s']:,.0f} "
        f"acts/s over its chunks after the first, "
        + ("alone on the card (no tenant's or scavenger's step child inside "
           "its step then)" if overlap == 0 else
           f"NOT alone: {overlap:.2f} s of its chunks overlapped a step "
           "child's step"))
    log(f"  (c)'s scavenger resumed to (b)'s group-001 bits "
        f"({rep['c']['acts_per_s']:,.0f} acts/s over its chunks after the "
        "first)")
    log(f"  phase 19: {rep['wall_s']:.1f} s (budget {FLEET_BUDGET_S:.0f} "
        f"s): (a) {rep['a']['wall_s']:.1f}, then (b) {rep['b']['wall_s']:.1f} "
        f"(the standalone sweep {rep['b']['standalone_sweep_s']:.1f} inside "
        f"it) + standalone eval "
        f"{rep['b']['standalone_s'] - rep['b']['standalone_sweep_s']:.1f} "
        f"beside (c) {rep['c']['wall_s']:.1f}")
    return rep

# --- phase 20: long-context harvest on a sequence-parallel ring, then the ----
# --- giant SAE at the LM's MLP width -----------------------------------------

# Pythia-70M's preset at full width (phase 13's model, seeded random
# weights), contexts of 8,192 tokens: 4x its published n_ctx of 2,048.
# The cut is depth: 16 contexts (131,072 rows a tap) in chunks of 65,536
# rows, DataArgs' model batch of 4, taps mlp.2 (d_mlp 2,048, the giant
# SAE's input) and residual.2 (d_model 512).
LC_CONTEXT, LC_CONTEXTS, LC_LAYER = 8192, 16, 2
LC_MODEL_BATCH = 4  # DataArgs' model_batch_size
LC_CHUNK_ROWS = 65536
LC_LOCS = {"mlp": LM_D_MLP, "residual": 512}  # layer_loc -> width
LC_WORLD = 2  # (b)'s gloo ranks sharing cuda:0
LC_TIMEOUT_S = 300
# harvested chunks against the single-device harvest's: one bf16 ulp of
# each value, plus RTOL_LC of max|ref| for the forwards' fp32 gap (ring
# attention's online softmax against the plain softmax)
RTOL_LC = 1e-5
# (a) the widened big-SAE kernels at BigSAEArgs' n: d past the old limit
# of 1,024 up to the kernels' widest (BIG_MAX_D = 4,096: gpt2-medium's and
# Pythia-410M's d_mlp); 1,500 is not a multiple of 8 (fp32 only)
WIDE_DS = (1032, 1500, 2048, 3072, 4096)
WIDE_BATCH = 8192
# a batch several workspace chunks long at d = 2,048: K8 fp32 16,384 +
# 16,384 + 4,096 rows, K9 fp32 4 x 8,192 + 4,096, K8 bf16 32,768 + 4,096,
# K9 bf16 6 x 5,440 + 4,224
WIDE_CHUNK_SHAPE = (36864, BIG_N, LM_D_MLP)
# (c) the giant SAE over (b)'s mlp.2 store: BigSAEArgs' n and batch at d =
# 2,048; 2 epochs of its 2 chunks = 4 steps a run, no resurrection
LC_BIG_EPOCHS = 2
LC_BIG_STEPS = LC_BIG_EPOCHS * LC_CONTEXTS * LC_CONTEXT // BIG_BATCH
LC_SIDE_CHUNKS = (0, 1, 0)  # (c)'s side by side: a step a chunk


def lc_model():
    """(cfg, params on the card, token rows [LC_CONTEXTS, LC_CONTEXT]):
    the same in every process that calls it."""
    from sparse_coding_tpu_torch.lm import gptneox
    from sparse_coding_tpu_torch.lm.model_config import get_config

    from sparse_coding_tpu_torch.config import DataArgs

    cfg = get_config(LM_MODEL)
    if (cfg.d_mlp, cfg.d_model, DataArgs().model_batch_size) != (
            LM_D_MLP, LC_LOCS["residual"], LC_MODEL_BATCH):
        raise AssertionError(f"phase 20 runs Pythia-70M's preset at "
                             f"DataArgs' model batch: {cfg}")
    params = gptneox.init_params(torch.Generator().manual_seed(SEED + 20),
                                 cfg, device=DEV)
    tokens = np.random.default_rng(SEED + 20).integers(
        0, cfg.vocab_size, size=(LC_CONTEXTS, LC_CONTEXT))
    return cfg, params, tokens


def lc_forward_check(params: dict, cfg, tokens: np.ndarray, mesh) -> dict:
    """The first context through ``sequence_parallel_forward`` on ``mesh``
    (this rank's block) and through the single-device forward on the
    card, every layer: the taps mlp.2 and residual.2 and the logits of
    this rank's positions within RTOL_LM of max|ref|."""
    from sparse_coding_tpu_torch.lm import gptneox
    from sparse_coding_tpu_torch.lm.long_context import (
        SEQ_AXIS,
        sequence_parallel_forward,
    )

    taps = (f"mlp.{LC_LAYER}", f"residual.{LC_LAYER}")
    toks = torch.as_tensor(tokens[:1]).to(DEV)
    s = LC_CONTEXT // mesh.shape[SEQ_AXIS]
    lo = mesh.coords[SEQ_AXIS] * s
    out = {}
    with torch.inference_mode():
        ref_logits, ref_taps = gptneox.forward(params, toks, cfg, taps=taps)
        ref = {t: ref_taps[t][:, lo:lo + s] for t in taps}
        ref["logits"] = ref_logits[:, lo:lo + s]
        del ref_logits, ref_taps
        logits, got = sequence_parallel_forward(params, toks, cfg, mesh,
                                                taps=taps)
        got["logits"] = logits
        for name, want in ref.items():
            err = float((got[name] - want).abs().max())
            scale = float(want.abs().max())
            if not err <= RTOL_LM * scale:
                raise AssertionError(
                    f"sequence-parallel {name} (positions {lo}-{lo + s}): "
                    f"|Δ|max {err:.3e} > {RTOL_LM} x max|ref| {scale:.3e}")
            out[name] = {"max_abs_err": err, "max_abs_ref": scale}
    del got, ref
    torch.cuda.empty_cache()
    return out


def lc_harvest(params: dict, cfg, tokens: np.ndarray, store: Path,
               mesh=None) -> dict:
    """harvest_activations over the token rows, one call a layer_loc (tap
    mlp.2, then residual.2), on ``mesh`` or on the card alone; each call's
    wall and tokens/s (host clock, chunk writes included)."""
    from sparse_coding_tpu_torch.data.harvest import harvest_activations

    out = {"wall_s": {}, "tokens_per_s": {}, "written": {}}
    for loc, width in LC_LOCS.items():
        sync()
        t0 = time.perf_counter()
        written = harvest_activations(
            params, cfg, tokens, layers=[LC_LAYER], layer_loc=loc,
            output_folder=store, model_batch_size=LC_MODEL_BATCH,
            chunk_size_gb=LC_CHUNK_ROWS * width * 2 / 2**30,
            dtype="bfloat16", mesh=mesh, device=DEV)
        sync()
        wall = time.perf_counter() - t0
        tap = f"{loc}.{LC_LAYER}"
        want = LC_CONTEXTS * LC_CONTEXT // LC_CHUNK_ROWS
        if written != {tap: want}:
            raise AssertionError(f"harvest wrote {written}, expected "
                                 f"{{{tap!r}: {want}}}")
        out["wall_s"][tap] = wall
        out["tokens_per_s"][tap] = LC_CONTEXTS * LC_CONTEXT / wall
        out["written"][tap] = written[tap]
    return out


def bf16_chunk(path: Path) -> torch.Tensor:
    """A bf16 chunk file's values, fp32 on the card."""
    raw = np.ascontiguousarray(np.load(path)).view(np.int16)
    return torch.from_numpy(raw).to(DEV).view(torch.bfloat16).float()


def lc_stores_close(label: str, got: Path, ref: Path) -> dict:
    """Each tap's chunks of ``got`` against the single-device harvest's
    ``ref``: meta.json equal but for digests, each value within one bf16
    ulp plus RTOL_LC of max|ref|; the values beyond one ulp alone and the
    chunks bitwise equal are counted."""
    out = {}
    for loc in LC_LOCS:
        tap = f"{loc}.{LC_LAYER}"
        gm = json.loads((got / tap / "meta.json").read_text())
        rm = json.loads((ref / tap / "meta.json").read_text())
        gd, rd = gm.pop("chunk_digests"), rm.pop("chunk_digests")
        if gm != rm:
            raise AssertionError(f"{label} {tap}: meta.json {gm} != {rm}")
        worst, over_ulp, values = 0.0, 0, 0
        for i in range(rm["n_chunks"]):
            a = bf16_chunk(got / tap / f"{i}.npy")
            b = bf16_chunk(ref / tap / f"{i}.npy")
            diff = (a - b).abs()
            mag = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
            ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
            excess = float((diff - ulp - RTOL_LC * b.abs().max()).max())
            if not excess <= 0:
                raise AssertionError(
                    f"{label} {tap} chunk {i}: beyond one bf16 ulp and "
                    f"{RTOL_LC} of max|ref| of the single-device harvest")
            worst = max(worst, float(diff.max()))
            over_ulp += int((diff > ulp).sum())
            values += diff.numel()
            del a, b, diff, mag, ulp
        out[tap] = {"chunks": rm["n_chunks"], "max_abs_err": worst,
                    "beyond_one_ulp": over_ulp, "values": values,
                    "bitwise_chunks": sum(gd[k] == rd[k] for k in rd)}
    torch.cuda.empty_cache()
    return out


def ring_worker(argv) -> int:
    """One rank of phase 20 (b)'s world: ``--ring-worker RANK WORLD RDZV
    OUT GO``. It joins the gloo world, builds the model, waits for the
    file GO (the parent's timed work done), then checks the sequence-
    parallel forward against the single-device one and harvests into
    OUT/store (rank 0 writes); its result goes to OUT/rank<RANK>.json."""
    import torch.distributed as dist

    from sparse_coding_tpu_torch.lm import gptneox
    from sparse_coding_tpu_torch.parallel.mesh import (
        initialize_distributed,
        make_mesh,
        shutdown_distributed,
    )

    rank, world = int(argv[0]), int(argv[1])
    rdzv, out, go = (Path(a) for a in argv[2:5])
    initialize_distributed(store=dist.FileStore(str(rdzv), world),
                           num_processes=world, process_id=rank,
                           backend="gloo", device_type=DEV,
                           timeout_s=LC_TIMEOUT_S)
    try:
        mesh = make_mesh(1, world, device_type=DEV)
        cfg, params, tokens = lc_model()
        # first-call costs (cuBLAS handles) before the wait
        with torch.inference_mode():
            gptneox.forward(params, torch.as_tensor(tokens[:1, :64]).to(DEV),
                            cfg, stop_at_layer=1)
        sync()
        t0 = time.perf_counter()
        while not go.exists():
            if time.perf_counter() - t0 > LC_TIMEOUT_S:
                raise TimeoutError(f"rank {rank}: no go file {go}")
            time.sleep(0.05)
        mesh.barrier()
        res = {"forward": lc_forward_check(params, cfg, tokens, mesh)}
        mesh.barrier()
        res["harvest"] = lc_harvest(params, cfg, tokens, out / "store", mesh)
        (out / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        shutdown_distributed()
    return 0


def lc_world_start(tmp: Path) -> tuple[list, Path, Path]:
    """Start (b)'s two ranks (this script's ``--ring-worker``); they build
    the model and wait for the go file."""
    out = tmp / "ring_world"
    out.mkdir()
    go = out / "go"
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--ring-worker",
         str(r), str(LC_WORLD), str(out / "rdzv"), str(out), str(go)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(LC_WORLD)]
    return procs, out, go


def lc_world_finish(procs: list, out: Path) -> list[dict]:
    """Wait for (b)'s ranks (killing any survivor); a rank that failed
    fails the phase. Returns each rank's result."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=LC_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"(b) ring world rank {r} exited "
                                 f"{p.returncode}:\n{text[-6000:]}")
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(LC_WORLD)]


def wide_kernels(g: torch.Generator) -> dict:
    """(a) K8 and K9, fp32 and bf16, against their plain versions at
    BigSAEArgs' n and d past 1,024 (phase 2's and phase 11's bounds, ReLU
    flips counted), then at a batch several workspace chunks long (fp32:
    its launch counts)."""
    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    checks = {}
    for d in WIDE_DS:
        p = big_params(g, BIG_N, d)
        x = torch.randn((WIDE_BATCH, d), generator=g).to(DEV)
        checks[f"fp32 d={d}"] = check_big_kernels(p, x, f"wide d={d}")
        if d % 8 == 0:
            checks[f"bf16 d={d}"] = big_bf16_check(p, x, f"wide bf16 d={d}")
        del p, x
        torch.cuda.empty_cache()
    b, n, d = WIDE_CHUNK_SHAPE
    p = big_params(g, n, d)
    x = torch.randn((b, d), generator=g).to(DEV)
    _build.reset_launches()
    checks["fp32 chunks"] = check_big_kernels(p, x, "wide chunks")
    want = big_launches(1, b, (1, 2))
    if dict(_build.LAUNCHES) != want:
        raise AssertionError(f"wide chunks: launches {dict(_build.LAUNCHES)}"
                             f", expected {want}")
    checks["bf16 chunks"] = big_bf16_check(p, x, "wide bf16 chunks")
    log(f"  (a) {b} rows at d={d}: fp32 {len(fb.fwd_chunks(b, n))} + "
        f"{len(fb.bwd_chunks(b, n))} chunks, bf16 "
        f"{len(fb.fwd_chunks(b, n, BF16))} + "
        f"{len(fb.bwd_chunks(b, n, BF16))}")
    del p, x
    torch.cuda.empty_cache()
    return checks


def wide_timing(g: torch.Generator, x: torch.Tensor) -> dict:
    """K8 and K9, fp32 and bf16, at BigSAEArgs' batch and n on the
    harvested mlp.2 rows ``x`` (d = 2,048): the kernel timed over 2
    launches after one (CUDA events), its plain version over one; the
    active codes and each kernel's bound."""
    from sparse_coding_tpu_torch.ops import fused_big_sae as fb

    b, d = x.shape
    p = big_params(g, BIG_N, d)
    xc = (x - p["centering"]).contiguous()
    nnz = int(((xc @ p["encoder"] + p["threshold"]) > 0).sum())
    alpha = torch.tensor(BIG_L1, device=DEV)
    bounds = {**big_bounds(b, BIG_N, d, nnz),
              **big_bf16_bounds(b, BIG_N, d, nnz)}
    out = {"active_codes": nnz, "bounds": bounds, "timing": {}}
    for name, cd in (("big_sae_fwd", "float32"), ("big_sae_bwd", "float32"),
                     ("big_sae_fwd_bf16", BF16), ("big_sae_bwd_bf16", BF16)):
        if name.startswith("big_sae_fwd"):
            kern = lambda: fb.big_sae_forward(p, xc, compute_dtype=cd)
            plain = lambda: fb.big_sae_forward_plain(p, xc, cd)
        else:
            r = (fb.big_sae_forward_plain(p, xc, cd) - x).contiguous()
            kern = lambda: fb.big_sae_backward(p, alpha, xc, r,
                                               compute_dtype=cd)
            plain = lambda: fb.big_sae_backward_plain(p, alpha, xc, r, cd)
        ms, plain_ms = time_ms(kern, 2), time_ms(plain, 1, warmup=0)
        out["timing"][name] = {"ms": ms, "plain_ms": plain_ms,
                               "library_ms": None}
        bnd = bounds[name]
        log(f"  (c) {name} at d={d}, batch {b}, n={BIG_N}: kernel "
            f"{ms:.2f} ms, plain {plain_ms:.2f} ms, bound "
            f"{bnd['bound_ms']:.2f} ms ({bnd['bound_by']}; "
            f"{100 * bnd['bound_ms'] / ms:.0f}% of it)")
        torch.cuda.empty_cache()
    log(f"  (c) {nnz} of {b * BIG_N} codes active "
        f"({100 * nnz / (b * BIG_N):.1f}%)")
    del p, xc
    torch.cuda.empty_cache()
    return out


def lc_big_train(store: Path, out_dir: Path, compute: str) -> dict:
    """train_big_sae over the mlp.2 store at d = 2,048 (use_fused "auto",
    as a user runs it; ``compute`` bf16: its step built with
    fused_compute_dtype bfloat16): LC_BIG_STEPS steps, each kernel once a
    step (counts zeroed just before), finite metrics; acts/s over steps
    2-LC_BIG_STEPS on the device timeline (CUDA events after each step,
    data loading included)."""
    from sparse_coding_tpu_torch.config import BigSAEArgs
    from sparse_coding_tpu_torch.ops import _build
    from sparse_coding_tpu_torch.train import big_sae as bs

    events, metrics = [], []
    real_make = bs.make_big_sae_step
    make = timed_big_steps(real_make, events, metrics,
                           fused_compute_dtype=compute)
    cfg = BigSAEArgs(activation_dim=LM_D_MLP, dataset_folder=str(store),
                     output_folder=str(out_dir), n_epochs=LC_BIG_EPOCHS,
                     seed=SEED)
    if (cfg.n_feats, cfg.batch_size) != (BIG_N, BIG_BATCH):
        raise AssertionError("phase 20 runs BigSAEArgs' n and batch")
    bs.make_big_sae_step = make
    try:
        _build.reset_launches()
        sync()
        t0 = time.perf_counter()
        bs.train_big_sae(cfg, device=DEV)
        sync()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    finally:
        bs.make_big_sae_step = real_make
    want = (big_bf16_launches(LC_BIG_STEPS) if compute == BF16
            else big_launches(LC_BIG_STEPS))
    if launches != want or len(events) != LC_BIG_STEPS:
        raise AssertionError(f"train_big_sae {compute}: {len(events)} steps, "
                             f"launches {launches}, expected {want}")
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    if not all(math.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"train_big_sae {compute}: non-finite metrics")
    window_s = events[0].elapsed_time(events[-1]) / 1e3
    acts_per_s = (LC_BIG_STEPS - 1) * BIG_BATCH / window_s
    log(f"  (c) train_big_sae {compute}: {LC_BIG_STEPS} steps, {wall:.2f} s "
        f"wall, {acts_per_s:.0f} acts/s over steps 2-{LC_BIG_STEPS} "
        f"({1e3 * BIG_BATCH / acts_per_s:.1f} ms a step); loss "
        f"{metrics[0]['loss']:.4g} -> {metrics[-1]['loss']:.4g}")
    return {"wall_s": wall, "acts_per_s": acts_per_s, "launches": launches,
            "metrics": metrics, "step_ms": 1e3 * BIG_BATCH / acts_per_s}


def long_context_phase(tmp: Path) -> dict:
    """Phase 20 (the module docstring's (a)-(c)), its timed steps alone on
    the card: the single-device and the 1 × 1 NCCL harvests, then (c)'s
    kernel times and training runs over the NCCL mesh's mlp.2 store; then
    the two-rank world harvests beside the untimed checks ((c)'s side by
    side, (a)), and its store is held against the single-device one. Its
    wall and each part's in the report."""
    import shutil

    import torch.distributed as dist

    from sparse_coding_tpu_torch.data.chunk_store import ChunkStore
    from sparse_coding_tpu_torch.lm import gptneox
    from sparse_coding_tpu_torch.parallel.mesh import (
        initialize_distributed,
        make_mesh,
        shutdown_distributed,
    )

    t_phase = time.perf_counter()
    rep: dict = {"part_s": {}}
    procs, world_dir, go = lc_world_start(tmp)
    ref_store, nccl_store = tmp / "lc_store_one", tmp / "lc_store_nccl"
    mlp = nccl_store / f"mlp.{LC_LAYER}"
    try:
        t0 = time.perf_counter()
        cfg, params, tokens = lc_model()
        with torch.inference_mode():  # first-call costs
            gptneox.forward(params, torch.as_tensor(tokens[:1, :64]).to(DEV),
                            cfg, stop_at_layer=1)
        rep["one"] = lc_harvest(params, cfg, tokens, ref_store)
        initialize_distributed(store=dist.FileStore(str(tmp / "lc_rdzv"), 1),
                               num_processes=1, process_id=0,
                               backend="nccl", device_type="cuda",
                               timeout_s=LC_TIMEOUT_S)
        try:
            mesh = make_mesh(1, 1, device_type="cuda")
            rep["nccl_forward"] = lc_forward_check(params, cfg, tokens, mesh)
            rep["nccl"] = lc_harvest(params, cfg, tokens, nccl_store, mesh)
        finally:
            shutdown_distributed()
        rep["nccl_vs_one"] = lc_stores_close("1x1 nccl", nccl_store,
                                             ref_store)
        del params
        torch.cuda.empty_cache()
        rep["part_s"]["b_one_device"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        x = torch.as_tensor(ChunkStore(mlp).load_chunk(0)).to(DEV)
        rep["timing"] = wide_timing(torch.Generator().manual_seed(21), x)
        del x
        torch.cuda.empty_cache()
        runs = {c: lc_big_train(mlp, tmp / f"lc_big_{c}", c)
                for c in ("float32", BF16)}
        for i, (a, b) in enumerate(zip(runs["float32"]["metrics"],
                                       runs[BF16]["metrics"])):
            rel = abs(b["loss"] - a["loss"]) / abs(a["loss"])
            if not rel <= RTOL_BIG_BF16_LOSS:
                raise AssertionError(
                    f"(c) bf16 step {i} loss {b['loss']} vs fp32 "
                    f"{a['loss']}: {rel:.2e} > {RTOL_BIG_BF16_LOSS}")
        rep["train"] = runs
        rep["part_s"]["c_timed"] = time.perf_counter() - t0

        # the world runs beside the untimed checks: two ranks sharing the
        # card give no throughput figure of a mesh anyway
        t0 = time.perf_counter()
        go.write_text("go")
        cs = ChunkStore(mlp)
        rep["side_by_side"] = big_side_by_side(
            [torch.as_tensor(cs.load_chunk(i)).to(DEV)
             for i in LC_SIDE_CHUNKS],
            "(c)")
        rep["a"] = wide_kernels(torch.Generator().manual_seed(20))
        rep["part_s"]["c_side_by_side_and_a"] = time.perf_counter() - t0
        ranks = lc_world_finish(procs, world_dir)
        rep["part_s"]["b_world_beside_them"] = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    rep["world"] = ranks
    rep["world_vs_one"] = lc_stores_close("1x2 gloo", world_dir / "store",
                                          ref_store)
    fwd_errs = {f"rank {r} {k}": v["max_abs_err"] / v["max_abs_ref"]
                for r, res in enumerate(ranks)
                for k, v in res["forward"].items()}
    fwd_errs.update({f"1x1 {k}": v["max_abs_err"] / v["max_abs_ref"]
                     for k, v in rep["nccl_forward"].items()})
    log(f"  (b) sequence-parallel forward vs one device, context "
        f"{LC_CONTEXT}: worst |Δ|/max|ref| {max(fwd_errs.values()):.2e} "
        f"(bound {RTOL_LM}) over " + ", ".join(sorted(fwd_errs)))
    for label, h in (("one device", rep["one"]), ("1x1 nccl", rep["nccl"]),
                     ("1x2 gloo (beside the checks)",
                      ranks[0]["harvest"])):
        log(f"  (b) harvest {label}: {LC_CONTEXTS} contexts of "
            f"{LC_CONTEXT} tokens, " + ", ".join(
                f"{tap} {h['tokens_per_s'][tap]:.0f} tokens/s "
                f"({h['wall_s'][tap]:.2f} s)" for tap in h["wall_s"]))
    for label, key in (("1x1 nccl", "nccl_vs_one"),
                       ("1x2 gloo", "world_vs_one")):
        log(f"  (b) {label} store vs one device: " + "; ".join(
            f"{tap} {v['chunks']} chunks, |Δ|max {v['max_abs_err']:.3e}, "
            f"{v['beyond_one_ulp']} of {v['values']} values beyond one "
            f"ulp, {v['bitwise_chunks']} chunks bitwise"
            for tap, v in rep[key].items()))
    for path in (ref_store, nccl_store, world_dir):
        shutil.rmtree(path)
    rep["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 20: {rep['wall_s']:.1f} s (budget 60 s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in rep["part_s"].items()))
    return rep


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", type=Path, default=None,
                    help="also write every measurement here as JSON")
    ap.add_argument("--mesh-worker", nargs=6, default=None,
                    metavar=("RANK", "WORLD", "RDZV", "OUT", "STORE",
                             "BIG_STORE"),
                    help="run one rank of phase 16 (c)'s world (started by "
                    "phase 16 itself)")
    ap.add_argument("--serve-restart", nargs=3, default=None,
                    metavar=("CACHE_DIR", "DICT_FILE", "OUT"),
                    help="run phase 17 (f)'s restarted serving process "
                    "(started by phase 17 itself)")
    ap.add_argument("--ring-worker", nargs=5, default=None,
                    metavar=("RANK", "WORLD", "RDZV", "OUT", "GO"),
                    help="run one rank of phase 20 (b)'s world (started by "
                    "phase 20 itself)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if args.mesh_worker:
        return mesh_worker(args.mesh_worker)
    if args.serve_restart:
        return serve_restart_child(args.serve_restart)
    if args.ring_worker:
        return ring_worker(args.ring_worker)
    from sparse_coding_tpu_torch.ops import _build

    report: dict = {}
    t_start = time.perf_counter()
    log("phase 1: card and build")
    card = card_line()
    log(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    out = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"  built {list(_build.KERNELS)} in {report['build_s']:.1f} s")
    spills, entry = [], ""
    # the two GEMM templates' kernels: fp32 SIMT (sgemm_simt.cuh), bf16
    # TMA + wgmma (bgemm_wgmma.cuh)
    templates = ("sgemm_kernel", "wgemm_kernel")
    inst = {t: {name: 0 for name in _build.KERNELS} for t in templates}
    for name in _build.KERNELS:
        for line in (out / f"{name}.log").read_text().splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry function" in line):
                log(f"  ptxas {name}: {line.strip()}")
            if "Compiling entry function" in line:
                entry = line
                for t in templates:
                    inst[t][name] += t in line
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if (m and (int(m.group(1)) or int(m.group(2)))
                    and any(t in entry for t in templates)):
                spills.append(f"{name}: {entry.strip()}: {line.strip()}")
    if spills:
        raise AssertionError(f"ptxas spilled in a GEMM template: {spills}")
    gemms, wgemms = ({k: v for k, v in inst[t].items() if v}
                     for t in templates)
    log(f"  GEMM template instantiations, no spills: fp32 {gemms}; bf16 "
        f"wgmma {wgemms}")
    # every chunked kernel runs its fp32 products on the SIMT template and
    # its bf16 form's on wgmma, and no other kernel instantiates either
    chunked_libs = {"big_sae_fwd", "big_sae_bwd", "sae_tied_fwd",
                    "sae_tied_bwd", "sae_untied_fwd", "sae_untied_bwd"}
    if set(gemms) != chunked_libs:
        raise AssertionError(f"GEMM template instantiations in {gemms}")
    if set(wgemms) != chunked_libs:
        raise AssertionError(f"wgmma bf16 GEMM template instantiations in "
                             f"{wgemms}")
    hgmma = {name: sass_count(out / f"lib{name}.so", "HGMMA")
             for name in sorted(chunked_libs)}
    log(f"  HGMMA instructions in the SASS: {hgmma}")
    if not all(hgmma.values()):
        raise AssertionError(f"no HGMMA in the wgmma libraries' SASS: "
                             f"{hgmma}")
    report["wgmma_gemm_instantiations"] = wgemms
    report["hgmma_sass"] = hgmma

    log("phase 2: kernels vs plain versions")
    g = torch.Generator().manual_seed(0)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=Path.cwd()) as tmp:
        store = Path(tmp) / "store"
        n_steps = N_CHUNKS * ROWS_PER_CHUNK // BATCH
        write_store(store, N_CHUNKS * ROWS_PER_CHUNK, seed=SEED)
        from sparse_coding_tpu_torch.data.chunk_store import ChunkStore

        x_main = torch.as_tensor(ChunkStore(store).load_chunk(0)[:BATCH])
        checks = {}
        for tag, shape in (("small", (3, 96, 96, 40)),
                           ("wide", (2, 64, 64, 600)),
                           ("d768", (2, 64, 64, 768))):
            checks[tag] = check_kernels(make_inputs(g, *shape), tag)
        for d in WIDTHS:
            checks[f"d{d}"] = check_kernels(make_inputs(g, 2, 64, 64, d),
                                            f"d{d}")
        main_inp = make_inputs(g, N_MEMBERS, BATCH, N_FEATS, D, x=x_main)
        checks["main"] = check_kernels(main_inp, "main")
        report["checks"] = checks
        tied_fwd = fwd_extras(main_inp, tied=True)
        report["tied_fwd"] = tied_fwd
        tied_bwd = tied_bwd_extras(main_inp)
        report["tied_bwd"] = tied_bwd
        untied_fwd = fwd_extras(main_inp, tied=False)
        report["untied_fwd"] = untied_fwd
        untied = untied_bwd_extras(main_inp)
        report["untied_bwd"] = untied
        nnz = active_codes(main_inp)
        timing = time_kernels(main_inp)
        bnd = bounds(main_inp, nnz)
        report["active_codes"] = nnz
        report["adam_bound_share"] = bound_shares(
            timing, bnd, ("sae_tied_adam_vjp",))
        del main_inp
        torch.cuda.empty_cache()
        checks["ratio16"] = check_chunked(
            torch.Generator().manual_seed(16),
            x_main.to(DEV, torch.float32).contiguous(), RATIO16_SHAPE,
            {"fwd": RATIO16_FWD_CHUNKS, "bwd": RATIO16_CHUNKS}, "ratio16")
        big_store = Path(tmp) / "big_store"
        big_gen, big_g = write_big_store(big_store, seed=SEED)
        held_out = big_gen.batch(big_g, 8192)
        big = big_phase2(big_store, g)
        report["big_kernels"] = big
        log(f"  phase 2 done at {time.perf_counter() - t_start:.1f} s")

        l1_values = [float(v) for v in np.logspace(-4, -2, N_MEMBERS)]
        for tied, phase in ((True, 3), (False, 4)):
            family = "tied" if tied else "untied"
            log(f"phase {phase}: {family} main path — basic_l1_sweep, "
                f"{N_MEMBERS} members, d={D}, n={N_FEATS}, batch {BATCH}, "
                f"{n_steps} steps, train_step_tiled")
            main = main_path(store, Path(tmp) / f"out_{family}", l1_values,
                             n_steps, tied)
            report[f"main_path_{family}"] = main
            kernels = TIED_KERNELS if tied else UNTIED_KERNELS
            step_ms = 1e3 * BATCH / main["acts_per_s"]
            shares = {k: timing[k]["ms"] / step_ms for k in kernels}
            main["step_ms"], main["kernel_share"] = step_ms, shares
            log(f"  {step_ms:.2f} ms per step; kernel shares "
                + ", ".join(f"{k} {100 * v:.1f}%" for k, v in shares.items()))
            log(f"phase {phase if tied else 5}: the {family} main path's "
                "epoch on autodiff")
            report[f"reference_{family}"] = reference_epoch(
                store, l1_values, main, tied)
            log(f"  done at {time.perf_counter() - t_start:.1f} s")

        log("phase 6: every kernel path vs autodiff")
        cs = ChunkStore(store).load_chunk(1)
        batches = [torch.as_tensor(cs[i * BATCH:(i + 1) * BATCH]).to(DEV)
                   for i in range(3)]
        report["other_paths"] = other_paths(batches, l1_values)
        log(f"  done at {time.perf_counter() - t_start:.1f} s")

        from sparse_coding_tpu_torch.config import BigSAEArgs

        dflt = BigSAEArgs()
        if (BIG_D, BIG_N, BIG_BATCH, BIG_L1, BIG_LR) != (
                dflt.activation_dim, dflt.n_feats, dflt.batch_size,
                dflt.l1_alpha, dflt.lr):
            raise AssertionError("the big-SAE main path must run at "
                                 "BigSAEArgs' default widths")
        log(f"phase 7: big-SAE main path — train_big_sae, d={BIG_D}, "
            f"n_feats={BIG_N}, batch {BIG_BATCH}, {BIG_STEPS} steps, "
            f"resurrection every {BIG_RESURRECT}")
        report["big_main"] = big_main_phase(big_store, Path(tmp), held_out)
        step_ms = report["big_main"]["step_ms"]
        shares = {k: big["timing"][k]["ms"] / step_ms for k in BIG_KERNELS}
        report["big_main"]["kernel_share"] = shares
        pair = {k: sum(big["timing"][n][k] for n in BIG_KERNELS)
                for k in ("ms", "plain_ms")}
        report["big_main"]["kernel_pair_ms"] = pair
        log(f"  {step_ms:.1f} ms per step; kernel shares "
            + ", ".join(f"{k} {100 * v:.1f}%" for k, v in shares.items())
            + f"; kernel pair {pair['ms']:.1f} ms vs plain pair "
            f"{pair['plain_ms']:.1f} ms; autodiff step "
            f"{report['big_main']['reference']['step_ms']:.1f} ms")
        log(f"  done at {time.perf_counter() - t_start:.1f} s")

        log(f"phase 8: the full sweep — train.sweep main, tied_vs_not, "
            f"{SWEEP_MEMBERS}+{SWEEP_MEMBERS} members, d={D}, n={N_FEATS}, "
            f"batch {BATCH}, {SWEEP_CHUNKS} chunks, a checkpoint each")
        sweep_store = Path(tmp) / "sweep_store"
        write_store(sweep_store, SWEEP_CHUNKS * ROWS_PER_CHUNK, seed=SEED + 8)
        report["sweep"] = sweep_phase(sweep_store, Path(tmp))
        log(f"  done at {time.perf_counter() - t_start:.1f} s")

        log(f"phase 9: the full sweep's host I/O — the orbax backend "
            f"(deferred swap) over a {len(SHARDS)}-shard store, phase 8's "
            "shape")
        ref = Path(report["sweep"]["a"]["out"])
        report["host_io"] = host_io_phase(sweep_store, Path(tmp), ref, card,
                                          report["sweep"]["a"]["host_io"])
        log(f"  done at {time.perf_counter() - t_start:.1f} s")

        log(f"phase 10: bf16 compute — the bf16 forms vs their plain "
            f"versions; bench.py's {len(BENCH_BF16_VARIANTS)} bf16 variants "
            f"through Ensemble, tied and untied, {n_steps} steps each")
        cs_main = ChunkStore(store)
        epoch = []
        for ci in range(N_CHUNKS):
            chunk = torch.as_tensor(cs_main.load_chunk(ci)).to(DEV)
            epoch += [chunk[i * BATCH:(i + 1) * BATCH]
                      for i in range(ROWS_PER_CHUNK // BATCH)]
        report["bf16"] = bf16_phase(x_main.to(DEV, torch.float32).contiguous(),
                                    epoch, l1_values,
                                    torch.Generator().manual_seed(10))
        del epoch
        torch.cuda.empty_cache()
        log(f"  done at {time.perf_counter() - t_start:.1f} s")

        log(f"phase 11: bf16 compute in the big SAE — the bf16 forms vs their "
            f"plain versions; {BIG_STEPS} bf16 steps at d={BIG_D}, "
            f"n_feats={BIG_N}, batch {BIG_BATCH} beside the fp32 kernels'; "
            "bench_suite's big-SAE variants")
        report["big_bf16"] = big_bf16_phase(big_store,
                                            torch.Generator().manual_seed(11))
        log(f"  done at {time.perf_counter() - t_start:.1f} s")

        log(f"phase 12: the model zoo — the recovery gate on the tied "
            f"kernels, basic_l1_sweep over a SparseMixDataset store and its "
            f"metrics; the {len(GROUP_EXPERIMENTS)} group experiments through "
            f"the CLI ({GROUP_CHUNKS} chunks each), card vs CPU; a topk kill "
            "and resume; the reference round trip")
        report["zoo"] = zoo_phase(sweep_store, Path(tmp))
        log(f"  done at {time.perf_counter() - t_start:.1f} s")

        log(f"phase 13: harvest on the card from {LM_MODEL} at full width "
            f"(random weights), taps mlp.{LM_LAYERS[0]} and "
            f"mlp.{LM_LAYERS[1]}; basic_l1_sweep tied and untied over the "
            f"mlp.{LM_LAYERS[1]} store at d={LM_D_MLP}, {LM_MEMBERS} "
            f"members, ratio {RATIO}, batch {BATCH}; kernels vs autodiff; "
            "scrub")
        report["lm"], lm = lm_phase(Path(tmp))
        log(f"  done at {time.perf_counter() - t_start:.1f} s")

        log(f"phase 14: evaluate on the card — the toy gate on the tied "
            f"kernels, a sweep over mlp.1, perplexity under reconstruction, "
            f"an ablation graph, IOI feature identification, erasure, the "
            f"sweeps, FISTA, concat, resurrection and the baselines, on "
            f"phase 13's {LM_MODEL} and its mlp.2 dicts")
        report["eval"] = eval_phase(Path(tmp), lm, sweep_store)
        torch.cuda.empty_cache()
        log(f"  done at {time.perf_counter() - t_start:.1f} s")

        log(f"phase 15: interpret features on the card — the fragment pass "
            f"and run at InterpArgs' defaults, card vs CPU, scan_batches, "
            f"the graph and investigate drivers, the snapshot drivers and "
            f"the CLI, the feature catalog and its query ops, the plotting "
            f"data, on phase 13's {LM_MODEL} and its mlp.2 dicts")
        report["interp"] = interp_phase(Path(tmp), lm)
        torch.cuda.empty_cache()
        log(f"  done at {time.perf_counter() - t_start:.1f} s")

        log(f"phase 16: the mesh — (a) the chunked backwards' data-sharded "
            f"form (total_batch) vs their plain versions, fp32 and bf16; (b) "
            f"basic_l1_sweep on a 1x1 NCCL mesh vs no mesh, bitwise; (c) a "
            f"two-rank gloo world on one card, meshes "
            f"{', '.join(f'{m}x{d}' for m, d in MESH_SHAPES)}: the ensembles "
            f"and the big SAE, {MESH_STEPS} steps each, vs one device")
        report["mesh"] = mesh_phase(Path(tmp), x_main.to(
            DEV, torch.float32).contiguous(), big_store, l1_values)
        torch.cuda.empty_cache()
        log(f"  done at {time.perf_counter() - t_start:.1f} s")

        log(f"phase 17: serving on the card — the registry (one of phase "
            f"13's tied mlp.2 dicts and the {LM_MEMBERS}-dict stack), CUDA-"
            f"graph warmup, correctness, online traffic through the gateway, "
            f"the drills, offline scoring, the catalog service and a "
            f"restart from the warmup manifest")
        report["serve"] = serve_phase(Path(tmp), lm["tied_dicts"],
                                      lm["store"] / f"mlp.{LM_LAYERS[-1]}",
                                      Path(tmp) / "catalog_a")
        tied_dicts = lm["tied_dicts"]  # phase 19 (c)'s gateway serves them
        del lm
        torch.cuda.empty_cache()
        log(f"  done at {time.perf_counter() - t_start:.1f} s")

        log(f"phase 18: the supervised pipeline on the card — harvest → "
            f"sweep → eval → catalog as step children (d={D}, "
            f"{PIPE_CHUNKS} chunks of {PIPE_CHUNK_ROWS} rows; "
            f"dense_l1_range, {PIPE_MEMBERS} tied members, ratio {RATIO}, "
            f"batch {BATCH}, a checkpoint set a chunk, a "
            f"{PIPE_PROFILE_STEPS}-step trace; eval on {PIPE_EVAL_ROWS} "
            "rows; the catalog); (b) kills at sweep.chunk and eval.write, "
            "then a resume; (c) a hung step; (d) fsck and the perf ledger; "
            "(e) the trace")
        report["pipeline"] = pipeline_phase(Path(tmp))
        log(f"  done at {time.perf_counter() - t_start:.1f} s")

        log(f"phase 19: Group-SAE and the fleet on the card — (a) the group "
            f"DAG ({len(FLEET_LAYERS)} layers of {FLEET_LAYER_CHUNKS} chunks "
            f"of {PIPE_CHUNK_ROWS} rows at d={D} → G={len(FLEET_GROUPS)}) "
            f"under a supervisor; (b) one fleet tenant per group "
            f"(dense_l1_range, {PIPE_MEMBERS} tied members, {FLEET_STEPS} "
            f"steps, eval), group-000 poisoned; (c) the elastic plane's "
            f"tide over the fleet and a 1-active/1-spare gateway on phase "
            f"17's registry")
        report["fleet"] = fleet_phase(Path(tmp), tied_dicts)
        log(f"  done at {time.perf_counter() - t_start:.1f} s")

        log(f"phase 20: long-context harvest and the giant SAE at the LM's "
            f"width — (a) big_sae_fwd/bwd and their bf16 forms vs their "
            f"plain versions at n={BIG_N}, d={', '.join(map(str, WIDE_DS))} "
            f"and {WIDE_CHUNK_SHAPE[0]} rows at d={WIDE_CHUNK_SHAPE[2]}; (b) "
            f"harvest_activations on a sequence-parallel ring, {LM_MODEL} "
            f"at full width, {LC_CONTEXTS} contexts of {LC_CONTEXT} tokens, "
            f"taps mlp.{LC_LAYER} and residual.{LC_LAYER}: one device, a 1x1 "
            f"NCCL mesh and a {LC_WORLD}-rank gloo world on the card; (c) "
            f"train_big_sae over the mlp.{LC_LAYER} store (d={LM_D_MLP}, "
            f"n={BIG_N}, batch {BIG_BATCH}), {LC_BIG_STEPS} steps fp32 and "
            f"bf16, {len(LC_SIDE_CHUNKS)} side by side with autodiff")
        report["long_context"] = long_context_phase(Path(tmp))
        log(f"  done at {time.perf_counter() - t_start:.1f} s")

    timing.update(big["timing"])
    bnd.update(big["bounds"])
    kernels = []
    for name in _build.KERNELS:
        # the float outputs' error; the outputs that count ReLU masks
        # (activity per feature, l0) apart — there a flipped mask moves a
        # count by 1, not a value by rounding
        if name in BIG_KERNELS:
            checked = big["checks"]["main"][name]
            launches = report["big_main"]["launches"][name]
        else:
            checked = checks["main"][name]
            family = "tied" if name in TIED_KERNELS else "untied"
            launches = report[f"main_path_{family}"]["launches"][name]
        # (a tied backward's flip counts carry no error)
        errs = {k: v for k, v in checked.items()
                if not is_mask_count(k) and "max_abs_err" in v}
        kernels.append({
            "name": name, "route": "cuda", **{
                k: KERNEL_META[name][k] for k in ("source", "replaces")},
            "launches": launches,
            "max_abs_err": max(v["max_abs_err"] for v in errs.values()),
            "max_rel_err": max(v["max_rel_err"] for v in errs.values()),
            "mask_count_abs_err": {k: v["max_abs_err"]
                                   for k, v in checked.items()
                                   if is_mask_count(k)},
            "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
            "bound_ms": bnd[name]["bound_ms"],
            "bound_by": bnd[name]["bound_by"],
            "library_ms": timing[name]["library_ms"],
            "contracts": KERNEL_META[name]["contracts"]})
        if name in BIG_KERNELS:
            kernels[-1]["parts"] = {
                k: {"launches": report["big_main"]["launches"][k],
                    "ms": v["ms"]}
                for k, v in big["extras"][name]["parts"].items()}
        chunked = {"sae_tied_fwd": (tied_fwd, "tied"),
                   "sae_tied_bwd": (tied_bwd, "tied"),
                   "sae_untied_fwd": (untied_fwd, "untied"),
                   "sae_untied_bwd": (untied, "untied")}
        if name in chunked:
            parts, family = chunked[name]
            kernels[-1]["parts"] = {
                k: {"launches":
                    report[f"main_path_{family}"]["launches"][k],
                    "ms": v["ms"]}
                for k, v in parts["parts"].items()}
    bf = report["bf16"]
    main_bf = bf["checks"]["main"]
    errs_of = {"sae_tied_fwd_bf16": main_bf["tied_fwd"],
               "sae_tied_bwd_bf16": {**main_bf["tied_bwd"],
                                     **main_bf["tied_bwd_masked"]},
               "sae_untied_fwd_bf16": main_bf["untied_fwd"],
               "sae_untied_bwd_bf16": main_bf["untied_bwd"],
               "sae_tied_adam_vjp_bf16":
                   main_bf["adam"]["sae_tied_adam_vjp_bf16"],
               "sae_untied_adam_vjp_bf16":
                   main_bf["adam"]["sae_untied_adam_vjp_bf16"]}
    for name, base in BF16_FORMS.items():
        # launches: bench.py's last bf16 variant (train_step, bf16 batches
        # and moments), which runs all three of the family's forms
        family = "tied" if name.startswith("sae_tied") else "untied"
        run = bf["ensemble"][f"{family} bf16 train_step, bfloat16 batch, "
                             "bfloat16 moments"]
        errs = [v for v in errs_of[name].values() if isinstance(v, dict)]
        t = bf["timing"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": KERNEL_META[base]["source"],
            "replaces": KERNEL_META[base]["replaces"],
            "launches": run["launches"].get(name, 0),
            "max_abs_err": max(v["max_abs_err"] for v in errs),
            "max_rel_err": max(v["max_rel_err"] for v in errs),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": bf["bounds"][name]["bound_ms"],
            "bound_by": bf["bounds"][name]["bound_by"],
            "library_ms": t["library_ms"],
            "contracts": KERNEL_META[base]["contracts"],
            "compute": "bf16 operands, fp32 accumulation"
            if "adam" not in name else "bf16 moments, fp32 update"})
        if "parts" in t:
            kernels[-1]["parts"] = {
                k: {"launches": run["launches"].get(k, 0), "ms": v["ms"]}
                for k, v in t["parts"].items()}
    bb = report["big_bf16"]
    bf_run = bb["steps"]["runs"][BF16]["launches"]
    for name, base in BIG_BF16_FORMS.items():
        # launches: phase 11's 16 steps on the bf16 forms
        errs = [v for k, v in bb["checks"]["main"][name].items()
                if isinstance(v, dict) and not is_mask_count(k)]
        t = bb["extras"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": KERNEL_META[base]["source"],
            "replaces": KERNEL_META[base]["replaces"],
            "launches": bf_run[name],
            "max_abs_err": max(v["max_abs_err"] for v in errs),
            "max_rel_err": max(v["max_rel_err"] for v in errs),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": bb["bounds"][name]["bound_ms"],
            "bound_by": bb["bounds"][name]["bound_by"],
            "library_ms": t["library_ms"],
            "contracts": KERNEL_META[base]["contracts"],
            "compute": "bf16 operands, fp32 accumulation",
            "parts": {k: {"launches": bf_run[k], "ms": v["ms"]}
                      for k, v in t["parts"].items()}})
    # phase 13's shape (d = LM_D_MLP): each ensemble kernel's launches on
    # its path (the fp32 sweeps; the bf16 forms' 3 steps), time and bound
    lm = report["lm"]
    for entry in kernels:
        name = entry["name"]
        base = name.removesuffix("_bf16")
        if base not in TIED_KERNELS + UNTIED_KERNELS:
            continue
        family = "tied" if base in TIED_KERNELS else "untied"
        runs = (lm["side_by_side"][family]["launches"]["bf16"]
                if name != base else lm[f"train_{family}"]["launches"])
        t = lm["kernels"]["timing"][name]
        b = lm["kernels"]["bounds"][name]
        entry[f"at_d{LM_D_MLP}"] = {
            "launches": runs[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}
    # phase 15 (e)'s sweep launches each tied kernel once a step
    for entry in kernels:
        if entry["name"] in TIED_KERNELS:
            entry["phase15_launches"] = \
                report["interp"]["snapshots"]["launches"][entry["name"]]
    # phase 16's mesh paths: (b)'s 1x1 NCCL sweep and each rank's runs in
    # (c)'s world
    mesh = report["mesh"]
    for entry in kernels:
        name = entry["name"]
        runs = ({"1x1 nccl basic_l1_sweep": mesh["b"]["launches"][name]}
                if name in TIED_KERNELS else {})
        for r, res in enumerate(mesh["c"]["ranks"]):
            for run, launches in res["launches"].items():
                if name in launches:
                    runs[f"rank {r} {run}"] = launches[name]
        if runs:
            entry["phase16_launches"] = runs
    # phase 18 (a)'s sweep child and phase 19 (b)'s group-001 tenant's,
    # read from their run reports
    for entry in kernels:
        entry["phase18_launches"] = \
            report["pipeline"]["a"]["launches"].get(entry["name"], 0)
        entry["phase19_launches"] = \
            report["fleet"]["b"]["launches"].get(entry["name"], 0)
    # phase 20 (c)'s train_big_sae runs at d = LM_D_MLP (fp32 and bf16
    # compute), and the big-SAE kernels' time and bound at that width
    lc = report["long_context"]
    for entry in kernels:
        name = entry["name"]
        entry["phase20_launches"] = {
            f"train_big_sae {c}": run["launches"].get(name, 0)
            for c, run in lc["train"].items()}
        if name in lc["timing"]["timing"]:
            t = lc["timing"]["timing"][name]
            b = lc["timing"]["bounds"][name]
            entry[f"at_d{LM_D_MLP}"] = {
                "launches": sum(entry["phase20_launches"].values()),
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}
    report["kernels"] = kernels
    report["timing"] = timing
    report["bounds"] = bnd
    report["card"] = card
    report["total_s"] = time.perf_counter() - t_start
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=2))
    log(f"done in {report['total_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
