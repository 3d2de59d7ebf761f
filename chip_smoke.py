#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper GPU: granite-3-2b at full width served (on the paged pool and on
per-slot stripes; with prefix sharing, preemption, spec decode, quality
tiers and chunked prefill; a 32,752-token prompt in query chunks; fused
q/k/v and gate/up projections) and retrained (also with bfloat16
parameters) (also data-parallel with FSDP
over two and four ranks), the paper's CNNs (ResNet-19 at full
width) trained and QAT-retrained, qwen2-moe-a2.7b, falcon-mamba-7b and
zamba2-2.7b served and retrained at full width (qwen2-moe-a2.7b also
expert-parallel over two and four ranks), and the qwen2-vl-2b and
musicgen-large backbones run, decoded and retrained on embeddings at full
width, through the hand-written CUDA kernels, each held against its plain
PyTorch version.

    python3 chip_smoke.py [--seed S] [--out report.json] [--profile]

Phases, each of which fails the run (non-zero exit, no result line):

1. build   nvcc builds every kernel under src/repro_torch/kernels/csrc for
           sm_90a; prints build seconds and the card's name and power limit.
2. K1      approx_matmul (CUDA) equals its plain version bit for bit at every
           (K, N) of granite-3-2b's projections with M = num_slots and
           M = one full prefill admission (timed, beside ``torch._int_mm`` on
           int8 views of the same codes: the exact product's cost alone), at
           M = 16, 32, 63, 64, 65 (both sides of the operand swap), for every
           registered multiplier at one mid shape with rhs_max 255 and 31,
           and on ragged shapes; then one decode step's K1 work, and the
           bound of one training step's 521 calls.
3. K2      paged_attention (CUDA) within 1e-4 of its plain version at the
           served shapes (H 32, Hkv 8, hd 64, block 16) and the test shapes,
           with sentinel holes, all-sentinel rows, cur_len on a block
           boundary, cur_len past the table and rows sharing their leading
           blocks (prefix sharing), each on a float32 and on a
           bfloat16 pool and each with a float32 and a bfloat16 query (the
           bf16-query output within 1e-4 plus bf16 rounding, and bit-equal
           to the f32 result rounded to bf16); one decode step
           (``paged_decode_attention``) over shared blocks through K2
           within 1e-4 of the gather's, writing only each row's cur_len
           slot; then one served decode step
           (40 calls, bf16 q as served) and one call at 4,096 positions
           (W = 256), each on both pool dtypes, every call checked the
           same way, then timed by CUDA events and by the profiler's device
           time, beside the bound, the plain version and SDPA over blocks
           gathered beforehand.
4. serve   8 seeded requests (prompts 16-128 tokens, 16-32 new tokens)
           through ServeSession(--exec approx, attn_impl="kernel",
           loop="sync") on the card, 4 slots, 16-row blocks; both kernels'
           launch counts, zeroed just before, must be > 0.
5. oracle  the first 2 requests again through a session on the plain
           versions (approx_lowrank, attn_impl="gather") on the card; the
           greedy tokens must be identical.  One decode step through K2 and
           through its plain version picks the same tokens, on a float32
           and on a bfloat16 pool.
6. K3      approx_mul_eltwise (CUDA, bit logic) on all 65,536 code pairs of
           mul8x8_1/2/3: equal to its plain version, to ``mul8x8_table`` and
           to the table K1 computes in one K = 1 call (``lut_mismatches``,
           the path K3 serves, counted with its launches zeroed just
           before); ragged 1-D (10**6 + 3) and 4-D cases; one 64 M-element
           call timed.
7. train   QAT retraining of granite-3-2b at full width (40 layers),
           mul8x8_2 through K1 (``mode="kernel"``), band_reg 1e-4, AdamW as
           ``launch/train.py`` sets it, batch 8 x seq 64 (every K1 call at
           M = 512): 3 steps through ``train_loop`` on ``token_batches`` with
           ``remat`` on (the config's default), each loss finite and K1's
           launch count (zeroed just before) > 0; step time, peak memory, a
           profiled step (K1's device share; K1 must show device time, so a
           renamed kernel symbol cannot hide) and steps with ``remat`` off.
           Oracle: one step at full width and 4 layers from identical
           state and batch with ``mode="kernel"`` and ``mode="lowrank"``
           (K1's plain version): bit-identical loss, parameters and
           moments.  Then ``launch/train.py --reduced`` runs 2 steps and a
           second call resumes from its checkpoint for 2 more.
8. paper   the paper's experiment through K1: (a) K1 bit-equal to its plain
           version at every im2col and FC shape of the seven Table VIII nets
           at batch 64 and 256 (ResNet-19's at 64 for all four Table VIII
           multipliers, each timed beside its bound); (b) Table VIII
           (``paper.table_viii``, --full protocol: 300 float steps, each
           multiplier's accuracy before and after 30 QAT steps), K1's count
           zeroed before each net and > 0 after it; (c) the JAX system
           test's LeNet-MNIST assertions (float accuracy > 0.8, mul8x8_2 DAL
           < 0.08, mul8x8_2 >= pkm - 0.02) on Table VIII's LeNet-MNIST
           model, with the test's own 80-step protocol run and printed
           beside it (at 80 steps the claim depends on the init,
           ``scripts/lenet_claim_seeds.py``); (d) ResNet-19 at full width,
           batch 64: 21 K1 launches per forward, QAT step time, peak memory,
           K1's device share of a profiled step (it must show device time),
           inference images per second at 256; (e) oracle: a forward of 256
           test images and one QAT step through K1 and through its plain
           version from identical state, bit-identical logits, loss and
           parameters.
9. slots   the slot layout at full width through K1 (``approx``, per-row
           scales, a float32 stripe of MAX_LEN per row), batch 4, prompts
           of 64 tokens, 32 new: (a) ``generate`` through K1 and through
           its plain version (``approx_lowrank``), with the fused and with
           the teacher-forced prefill, 4 layers deep: identical greedy
           tokens in each mode, K1's count (zeroed just before) > 0; (b)
           at 40 layers, ``greedy_generate_legacy`` identical to
           ``generate(prefill_mode="decode")``, and the share of tokens on
           which the two prefills agree, with the first divergence and its
           logit gap; (c) phase
           4's trace through ``ServeSession(cache_layout="slots")``: every
           request's tokens equal those of a paged session attending
           through K2's plain version (the slot layout's own attention
           arithmetic; the tokens that differ from phase 4's K2 session,
           whose online softmax rounds otherwise, are printed), and the
           first two requests equal ``generate`` of each prompt alone; (d) timings:
           ``kernel_bench._decode_bench`` at full width (legacy and
           generate tok/s; its two runs are (b)'s legacy and fused runs),
           the slot session's tok/s and TTFT, and with --profile its
           steady decode tick beside phase 4's.
10. async  the async double-buffered loop and the multi-token paged pass at
           full width (phase 4's weights re-created from the seed): (a)
           phase 4's trace through ServeSession(loop="async",
           attn_impl="kernel"): every request's tokens and admission tick
           and the session's ticks equal phase 4's sync run, each finish
           tick equal or one tick later (the async loop finishes a request
           at the harvest after its last chunk), and K1's and K2's launch
           counts, zeroed just before, > 0; (b) the same with
           steps_per_tick=4 and (c) with prefill_decode_ratio=1.0:
           identical tokens, (c)'s decode gap within steps + ceil(R *
           steps); (d) through K1: ``paged_verify_step`` over 5 tokens of
           4 admitted requests bit-equal (logits and pool) to 5 sequential
           ``paged_decode_step(attn_impl="gather")`` calls, and a 128-token
           prompt in chunks of 32 through ``paged_chunk_prefill_step``
           bit-equal to one verify pass over it (its gap to ``forward`` is
           printed); (e) tok/s, TTFT, overlap_fraction and host_block_s of
           the sync loop (run again), async, async x4 and the ratio run, and
           with --profile a steady async tick beside phase 4's sync tick.

11. share  prefix sharing, preemption and self-speculative decoding at full
           width, FEATURE_LAYERS deep (the weights re-created from the
           seed at that depth), served async on 4
           slots of 16-row blocks through K1 and K2: (a) 8 requests sharing
           a 64-token system prompt (tails of 8-40, 16-24 new) with and
           without ``prefix_sharing``: >= 28 prefix-hit blocks, fewer peak
           blocks, a clean drained pool, each hit block's K/V bit-equal to
           the request's own prefill in the unshared run, tokens bit-equal
           to the unshared run's; then 3 identical 72-token prompts: >= 1
           copy-on-write fork, tokens identical to each other and to the
           unshared run; (b) phase 4's first 4 requests with
           ``preemption`` in a pool above every single worst case that
           admits two prompts but not two worst cases: >= 1 preemption, a
           higher peak concurrency than the reservation in the same pool
           (run 4 layers deep: its admissions do not depend on the depth),
           each victim's tokens before its eviction bit-equal to an
           unstarved run's and after each replay to a fresh session
           admitted with the replay prompt, and whether its whole stream
           equals the unstarved run's (else the first divergence and its
           logit gap in ``forward``); (c) ``spec_decode`` with an
           ``exact_quant`` per-row verifier and a mul8x8_2 draft through K1
           and K2 (draft_k 4) on phase 4's trace, async (the sync loop on
           its first request, 8 new tokens): tokens bit-equal to the
           non-speculative ``exact_quant`` session through the gather,
           accept rate, tokens per verify and tok/s beside that session's;
           the self-test (the verifier's own mode drafting, 20 new tokens
           on the first 2 requests) through the gather at accept rate 1.0,
           and through K2 printed; one ``dynamic_draft_k`` run (first
           request); the accept rates of mul8x8_1/2/3 drafts on the first
           2 requests 4 layers deep.  Every spec run's tokens are
           bit-equal to the non-spec session's.  K1's and K2's counts are
           zeroed just before each feature session (sharing on, the shared
           copy-on-write run, the preemption run, each spec run) and read
           just after; each session must launch the kernels its path runs
           (the self-test drafts without K1, through the gather without
           K2), and the sums are the paths' launches.  The baselines and
           oracles are not counted.
12. tiers  quality tiers with the load shedder, and chunked prefill, at full
           width ((a) and (b) FEATURE_LAYERS deep, (c) at 40 layers; phase
           4's model and seed, float weights re-created from
           the seed: the ``exact`` rung needs them, the quantized rungs
           quantize them per call), async on 4 slots of 16-row blocks
           through K1 and K2: (a) the ladder exact / approx / approx_msr
           (mul8x8_2, so the MSR rung is mul8x8_msr4), 8 requests of 16-64
           prompt tokens and 8-16 new, rungs round-robin (the last at tier
           None), 2 arriving per tick: every request's tokens bit-equal to
           a single-mode session of its rung serving that rung's requests
           alone, each arriving at the tick the tier session admitted it
           (so the oracle prefills it in the same batch: on the card the
           rounding of a prefill follows its rows and bucket, and the exact
           rung is bf16 float), the sync loop's to the async loop's, the
           exact rung's session launching no K1; ``active_per_tier`` over
           the run and tok/s and seconds per tick beside the single-mode
           sessions'; (b) a burst of 12 such
           requests at ticks 0-1, all at the best rung, with the shedder
           (queue depth 4, hold 4, restore fraction 0.5), stepped on after
           the drain until restored: demotions, restorations, the shed
           level after every step and each request's effective rung equal
           to the same session's on the CPU at reduced width (a schedule
           is shape-only: no eos, and no value reaches it), final level 0,
           and every request's tokens equal to its effective rung's
           single-mode session; (c) chunked prefill on phase 4's frozen
           weights (40 layers): phase 4's trace and two 300-token prompts (past
           the largest bucket, 128), chunks of 64, prefill_decode_ratio
           1.0, max_len 336: async and sync bit-equal; chunks of 32
           bit-equal for every prompt both sizes chunk (the chunk pass runs
           per position at a fixed width of 4 rows, so it is
           chunk-invariant); ``prefill_chunks`` equal to the chunk plan's
           rows; a request whose prefill is fused in either run (one-shot
           under 64 tokens; the unchunked session, buckets to 512, max_len
           544, for all) bit-equal or equal up to a first divergence where
           the two tokens' logits in ``forward`` lie within NEAR_TIE (the
           two arithmetics' near tie, printed with the top two logits);
           the decode gap and phase 4's requests' TTFT chunked and
           unchunked.  K1's and
           K2's counts are zeroed just before each feature session (both
           mixed runs, the burst, the three chunked runs) and read just
           after; each must launch both.  The oracles, the CPU schedule
           and the unchunked session are not counted.
13. families  the moe, ssm and hybrid families at full width, one model
           at a time: qwen2-moe-a2.7b (24 layers, d 2048, 16/16 heads of
           128, 60 experts top-4 of ff 1408, a shared expert of 5632) on
           the paged pool through K1 and K2, falcon-mamba-7b (64 Mamba-1
           layers, d 4096, d_inner 8192) and zamba2-2.7b (54 Mamba-2
           layers in 9 groups of 6, each group followed by the shared
           attention block) on the slot layout through K1; random weights
           from the seed, built and frozen one layer at a time (approx,
           mul8x8_2, per-row scales), a float32 cache, 4 slots, greedy.
           The trace per model: 6 requests of 8-32 prompt tokens (buckets
           16/32) and 8-12 new, 2 at tick 0, then 1 per tick (the moe
           model's cut to its first 4 requests, 8 new tokens each).  (a) K1
           bit-equal to its plain version at each new (K, N), at M = 4 and
           the first admission's M (an expert's: its capacity); K2 at the
           moe shape (B 4, H 16, Hkv 16, hd 128) within 1e-4 on both pool
           dtypes with holes and cur_len on a block boundary, and one
           served decode step's 24 calls timed beside the bound, the plain
           version and SDPA.  (b) the trace at full depth on the async
           loop: finite tokens in the vocabulary, K1's count (zeroed just
           before) equal to the passes of the same session rehearsed on the
           CPU at reduced width times one pass's calls (every expert's
           three, empty ones included), K2's > 0 for the moe model and 0
           for the others; tok/s, admission seconds (CUDA events), peak
           memory, the dropped assignments per admission (moe), the scans
           against the teacher-forced decode (printed), and with --profile
           a steady tick's host ms and device idle share.  (c) 4 layers
           deep (the hybrid: one group of 6), weights from seed + 1: the
           session through K1 bit-equal to one through K1's plain version
           and the sync loop to the async; the moe model's decode step
           through K2 against the gather's (equal, or a recorded near tie
           within NEAR_TIE); ssm/hybrid ``forward`` (the chunked scans)
           within JAX's tolerance (|d| <= 2e-3 + 2e-2 |ref|) of the prompt
           teacher-forced through ``decode_step``, float32 and float
           execution, and each request's tokens equal to
           ``generate(prefill_mode="decode")`` of its prompt alone or a
           recorded near tie.  The moe unit also runs phase 18 on (b)'s
           and (c)'s weights and K1 async runs.
14. train  QAT retraining of the moe, ssm and hybrid families at full width
           through K1, as ``launch/train.py`` trains (mul8x8_2, band_reg
           1e-4, AdamW, remat on, batch 8 x seq 64): qwen2-moe-a2.7b 1
           layer deep, falcon-mamba-7b 2, zamba2-2.7b 6 (one group)
           (TRAIN_DEPTHS: the cuts fit a unit's float32 parameters,
           gradients and both moments beside the pool, and the pool's
           memory-time within the run's limit).  The steps run on rank 0
           of phase 19 (b)'s dp=2 world of the family (``train_dp_rank``),
           as its reference.  2 steps with K1's
           count zeroed just before and read just after: finite losses,
           the moe's load-balance term > 0, K1's launches equal to the
           steps times ``k1_per_train_step`` (every projection, then the
           recompute of each layer in the backward); step seconds, peak
           memory, one profiled step's device ms by kernel.  Oracle, 4
           layers deep or the trained depth where that is less (the
           hybrid: one group of 6; qwen2-moe-a2.7b at its 1), from one
           fresh state
           and batch: a step through K1, the same step through K1 again
           and through K1's plain version (``lowrank``): losses and whole
           new states (``state_digest``) bit-identical.  Then
           ``launch/train.py --arch <family> --reduced`` runs 2 steps and a
           second call resumes from its checkpoint for 2 more.
15. backbones  qwen2-vl-2b (28 layers, d 1536, 12/2 heads of 128, m_rope
           sections 16/24/24) and musicgen-large (48 layers, d 2048, 32/32
           heads of 64, sinusoidal positions) at full width on seeded
           embeddings (2 rows of 32): first K1 bit-equal to its plain
           version at every (K, N) of the model's projections, at M = 2
           (a decode step), 4 and 64 (a forward pass of 2 x 32); then
           (a) ``forward`` through K1 with
           frozen weights (approx, per-row scales; qwen2-vl with a
           ``positions_thw`` grid: an image of 4 x 4 patches after an
           8-token prefix, which must move the logits): finite logits, K1
           launched once per projection (197 and 337); (c) the embeddings
           teacher-forced through ``decode_step`` on the slot layout (the
           gather), each step's logits within JAX's tolerance of
           ``forward``'s at default positions (m_rope with equal streams
           is rope) or the same argmax or a near tie (NEAR_TIE); (d) the
           same through ``paged_decode_step`` through K2, every K2 call
           held against its plain version (within 1e-4, plus bf16
           rounding for the bf16 query), each step's logits equal to the
           slot step's or near ties; K1's and K2's counts, zeroed before
           (a) and read after (d), equal to the passes times one pass's
           calls and to layers x steps; then 4 layers deep in float32 the
           teacher-forced decode within JAX's tolerance of ``forward``;
           (b) training on embeddings as in phase 14, with phase 19
           (b)'s dp=2 world (musicgen 2 of its 48 layers, qwen2-vl 2 of
           its 28, with a positions grid), and its oracle at that depth.
16. roofline  the launch tooling (``launch/roofline.py``, ``specs.py``,
           ``dryrun.py``) held to the card on granite-3-2b at full width:
           one fused admission prefill (2 rows at bucket 128 into a 40-block
           f32 pool) and one paged decode step of 4 rows (K1 and K2) on
           phase 4's frozen weights, and phase 7's 8 x 64 QAT step (K1,
           remat) on its state (the step phase 7 profiles), each counted
           from 1 and 2 layers (``dryrun.in_depth``; on meta, the decode
           step on the CPU, where K2's work is read from the table and
           lengths), then run with the launch counts zeroed just before:
           the launches equal the counted calls (decode 281 and 40,
           prefill 281 and 0, train 521 and 0), the counted argument bytes
           equal the real tensors', the bound is at most 1.05x the
           profiler's device time, and the counted temporaries are within
           TEMP_TOL of those ``max_memory_allocated`` shows; printed beside
           each: device, CUDA-event and host ms, the bound and its term,
           and the model-FLOP share of the device time (2 N tokens, 6 N
           tokens for training, over the bf16 peak).  The dry run of every
           cell on meta needs no card: ``tests/test_torch_dryrun_cells.py``
           and ``python -m repro_torch.launch.dryrun --all`` run it.
17. tp     tensor-parallel serving (``ServeSession(mesh=TPMesh(...))``) of
           granite-3-2b at full width, each rank a process on the one card
           over gloo with CUDA tensors (one card cannot host two NCCL
           ranks; the multi-card NCCL path of ``launch/serve.py --tp`` is
           not run here), the weights built from the seed in the unit (the
           tp=1 references') and handed to the ranks through a file, each
           rank keeping its part: (a) K1 bit-equal to its plain
           version at every per-rank (K, N) of tp=2 and tp=4 (M = 4 and
           512), and K2 within K2_TOL at each rank's heads (16 over 4 and 8
           over 2, hd 64), both pool dtypes, with and without holes; (b)
           phase 4's trace at FEATURE_LAYERS (10), tp=2, through the
           gather: every rank's tokens identical to a tp=1 gather
           session's at that depth; (c) the same through K2: identical to
           a tp=1 K2 session's, or parted at a
           near tie (K2 splits a rank's table walk by its own head count:
           ``split_plan``) within NEAR_TIE in ``forward``, the gap printed;
           (d) tp=4 at 4 layers through K2 against tp=1 at 4 layers, the
           same rule; (e) every rank: the same tokens and ticks as tp=1,
           K1's launches (zeroed just before) ``k1_per_pass`` (281) per
           decode tick and per admission, K2's one per layer per tick (40),
           its pool bytes 1/tp of tp=1's, ``stats.tp`` and ``devices``.
           Printed: host ms per tick at tp against tp=1 (both under the
           pool's load), collectives per tick and their host ms, the
           unit's seconds.
18. ep     MoE expert parallelism (``ServeSession(mesh=TPMesh(...))`` on
           qwen2-moe-a2.7b at full width: each rank holds E/tp of the 60
           routed experts whole and runs them through K1, one all-gather
           of their output rows per layer; the shared expert and the
           attention split column/row as in phase 17), ranks as processes
           on the one card over gloo, run inside phase 13's qwen2-moe-a2.7b
           unit: its tp=1 reference is that unit's own run of phase 13's
           cut trace (4 requests, 8 new tokens, async, through K2), (c)'s
           K1 async run at 4 layers (**cut from (b)'s full depth for
           tp=2**), with K1's, K2's and the collectives' counts
           zeroed just before (``counted_run``); its weights (approx,
           mul8x8_2, per-row scales, from seed + 1) reach the ranks through a file
           written while the unit goes on, each rank keeping its part of
           an mmap load.  (a) K1 bit-equal to its plain version at
           every per-rank (K, N) this phase adds (the shared expert's,
           attention's and the head's at tp=2 and tp=4, an expert's
           column/row parts at tp=8) at M = 4, the decode capacity (8)
           and the first admission's rows; K2 within K2_TOL at each rank's
           heads (8 over 8 and 4 over 4, hd 128), both pool dtypes, with
           and without holes.  (b) tp=2 and (c) tp=4 at
           ORACLE_LAYERS (4): every rank's
           tokens identical to the tp=1 session's at that depth or parted
           at a near tie within NEAR_TIE, the gap printed.  (d) every
           rank: rank 0's tokens, tp=1's ticks and dropped assignments,
           K1's launches (zeroed just before) ``k1_per_pass(cfg, tp)`` per
           pass (L (4 + 3 E/tp + 3) + 1; tp=1's passes), K2's one per
           layer per tick, ``collectives_per_pass`` per pass, 1/tp of
           tp=1's pool and of the whole model's expert codes, ``stats.tp``
           and ``devices``.  Printed: host ms per tick at tp against tp=1
           (both under the pool's load), collectives per tick and their
           host ms, gathered MB per tick, each rank's weight GB and peak,
           the phase's seconds within the unit.
19. dp     training over a mesh (``make_train_step(...,
           mesh=TrainMesh(...))``) of granite-3-2b at full width as
           ``launch/train.py`` trains (mul8x8_2 through K1, band_reg 1e-4,
           remat, AdamW, global batch 8 x 64), ranks as processes on the
           one card over gloo with CUDA tensors (the multi-card NCCL path
           of ``launch/train.py --mesh`` is not run here), each holding
           its block of every weight the rules split (1/dp over data, 1/tp
           over model) and of its moments; one world of 4 rank processes
           runs the meshes in turn (DP_WORLDS' order: (f), (b)-(c), (d)),
           each carved from its first ranks, then (a): K1 bit-equal to its plain
           version at granite's projections' (K, N) at each rank's M (256)
           and at every per-rank (M, K, N) of the 2x2 and 2x1x2 worlds,
           fused too (``k1_shapes_per_rank``: the column parts (2048,
           1024), (2048, 256), (2048, 4096), (2048, 24,832), (2048, 1536),
           (2048, 8192), the row parts (1024, 2048), (4096, 2048));
           (b)-(c) dp=2 at DP_LAYERS (2): DP_STEPS (2) steps on the seed's
           state and ``token_batches``, each against one device's step
           from the same state and batch (rank 0 steps the seed's whole
           state, then the state it gathered after the step before): the
           loss within DP_LOSS_RTOL and the whole new parameters and
           moments within ``DpClose``'s tolerance, every rank the same
           losses, K1's launches per rank DP_STEPS x
           ``k1_per_train_step`` (27), the collectives per rank and step
           ``collectives_per_train_step`` (87), the GB gathered
           ``gathered_bytes_per_train_step``, the state bytes per rank
           ``state_bytes_per_rank``, exactly; (d) a 2x2 world (data x
           model: Megatron-split projections, FSDP over data) at DP_LAYERS,
           the same gates at its sizes, then dp=2's checkpoint restored on
           it, each rank's block equal, bit for bit, to its cut of the
           one-device restore (``state_digest``); (e) rank 0's checkpoint
           of dp=2's last state restored on one device equal, bit for bit,
           to each dp=2 rank's part; (f) a 2x1x2 world (pod x data x
           model: the batch over the two pods, no data split), the same
           gates as (d).
           (a) also checks K1 at every per-rank (M, K, N) of each other
           family's dp=2 step (``k1_shapes_per_rank``: M 256, a MoE's
           experts the 40 rows of its global capacity).  (b) for every
           other family, inside its phase 14 or 15 unit at that phase's
           depth and batches: a dp=2 world whose rank 0 takes the phase's
           one-device steps (``train_dp_world``), each dp step held to the
           one-device step from the same state as in (c), with the same
           count gates; a MoE routes over the global batch, and each
           routing call's dropped assignments are printed beside the
           one-device step's.
           Printed: host seconds per step on each world against dp=2's and
           one device's, collectives and their host ms, GB gathered per
           step, state and peak GB per rank.
20. levers query chunking (``ModelConfig.q_chunk``), the fused
           projections (``fuse_qkv``, ``fuse_gate_up``) and bfloat16
           parameters (``param_dtype``) at full width, phase 4's config and
           weights from the seed: (a) ``attention_core`` at granite's heads
           (32 over 8, hd 64), bf16 q/k/v, one row of 4,096 positions,
           causal, in chunks of 512 within CHUNK_TOL (1e-5) of the whole
           call, each call's temporaries printed beside the prediction;
           (b) one request of a 32,752-token prompt and 8 greedy tokens,
           LEVER_LAYERS (20) deep, through ``ServeSession`` (paged, f32 pool, one slot, bucket and
           max_len 32,768: 2,048 blocks a row, ``q_chunk`` 512) through K1
           and K2: first K1 bit-equal to its plain version on rows of the
           head's full prefill product (M x N = 1.63e9 outputs) and K2
           within K2_TOL at W = 2,048 on both pool dtypes; the prefill
           (``forward`` of the padded prompt) with its temporaries within
           TEMP_TOL of the dry run's count of that shape and finite logits
           whose argmax is the session's first token; K1's launches
           ``k1_per_pass`` times the passes, K2's one per layer per tick;
           the 8 tokens equal to the same session's through the gather,
           or parted at a near tie within NEAR_TIE in ``forward``; the
           seconds to first token and the GB the unchunked scores would
           take; (c) K1 bit-equal at the fused (K, N) (2048 x 3072 and
           2048 x 16,384, and their parts at tp 2 and 4) at M = 4 and 512;
           phase 4's first 2 requests through a session with both fusions
           (the fused frozen leaves built once, ``fuse_params``) and one
           without: both equal to phase 4's tokens, K1's launches
           ``k1_per_pass`` per pass (161 fused, 281 not); host ms per
           decode tick of each printed; (d) one QAT step 4 layers deep
           with bf16 parameters and both fusions: through K1, again and
           through K1's plain version (``lowrank``) from identical state,
           bit-identical loss, parameters and moments (``train_oracle``);
           its parameter bytes and peak beside a float32 unfused step's,
           and the dry run's bytes a dp=2 step gathers at 4 layers in each
           dtype.

Phases 1-7 run in this process, one after another, and so do the parts
whose times go into the kernels line: phase 8's K1 at the CNN shapes,
phase 10's stall probe (its gates are host times) and phase 13's K2 at the
moe shape, and phase 16 (its serving steps after phase 5, its training
step inside phase 7).  The rest of phases 8-15 and phases 17-20 then run as units (phase
8; 9; 10; 11; 12 (a)-(b), 12 (c) and its sync run; each model of 13, 14
and 15 (13's qwen2-moe-a2.7b with 18; 14 and 15 with 19 (b)); 17; 19; 20;
the ranks of 17 and 18 are processes of their own, and so are those of 19
but rank 0, which runs in its unit's process) in up to POOL_WORKERS processes on the one card at once, as many
as the units' budgets allow (POOL_GB; a unit's budget may fall as it
goes, ``next_budget``), each unit in a fresh process:
serving is host-bound, and processes sharing the card each serve at the speed of one
alone (``scripts/shared_card_probe.py``), so the phases' seconds add up to
more than the run's.  The tok/s, host ms and admission seconds those units
print are taken while the other units run.  Each unit zeroes and reads its
own kernels' counts; its log is printed when it ends.

Activations use per-row scales (``act_per_row``), so a request's tokens do
not depend on which other requests share its batch, and the oracle can
replay a subset of the trace.  The weights are random, from ``--seed``.

Timings are CUDA-event means over repeated launches; a bound is the larger
of the bytes the call must move over 3.35 TB/s and its operations over the
peak rate of their type (int8 1978.9 TOP/s for the uint8 codes of K1, f32
67 TFLOP/s for K2, which computes in f32 from either pool dtype; K3 moves
2 bytes in and 4 out per element and its integer logic has no rate in the
data sheet).  The rates, ``bound`` and ``k2_bound`` come from
``repro_torch/launch/roofline.py`` (the H100 SXM data sheet at 700 W, by
``torch.cuda.get_device_name()``); the card's name and power limit, as
``nvidia-smi`` gives them, are printed beside them.  The line before the
last is {"kernels": [...]}; the last line is {"ok": true, "device":
{...}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import multiprocessing as mp
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
if (SRC / "repro_torch").is_dir():      # outside a checkout main() says so and exits 2
    sys.path.insert(0, str(SRC))
    from repro_torch.launch.dryrun import (collectives_per_train_step,
                                           gathered_bytes_per_train_step, k1_per_pass,
                                           k1_per_train_step, k1_shapes_per_rank,
                                           state_bytes_per_rank)
    from repro_torch.kernels.work import k2_valid_positions
    from repro_torch.launch.roofline import INT8_OPS_PER_S, bound, k2_bound

ARCH = "granite-3-2b"
NUM_SLOTS = 4
BLOCK_SIZE = 16
BUCKETS = (16, 32, 64, 128)
MAX_NEW = 32
REQUESTS = 8
MAX_LEN = 160                        # largest bucket + MAX_NEW, whole blocks
SLOT_PROMPT = 64                     # phase 9's generate prompts
VERIFY_S = 5                         # phase 10's verify pass: tokens per row
STALL_MS = 1000                      # phase 10's queued device stall, longer than a tick
CHUNK_PROMPT, PREFILL_CHUNK = 128, 32  # phase 10's chunked prefill
K2_TOL = 1e-4
K2_POOLS = {"f32": torch.float32, "bf16": torch.bfloat16}
LONG_CONTEXT = 4096                  # granite-3.0-2b's context length
K3_DESIGNS = ("mul8x8_1", "mul8x8_2", "mul8x8_3")
K3_TIMED_N = 1 << 26                 # 64 M elements
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 64, 3
ORACLE_LAYERS = 4
FEATURE_LAYERS = 10                  # phase 11's and 12 (a)-(b)'s depth: the time limit
SYSTEM_PROMPT = 64                   # phase 11's shared system prompt: 4 blocks
COW_PROMPT = 72                      # phase 11's identical prompts, ending in a partial block
PREEMPT_REQUESTS = 4                 # phase 11's preemption trace: phase 4's first requests
PREEMPT_BUCKETS = BUCKETS + (256,)   # ... whose replay prompts reach 159 tokens
PREEMPT_MAX_LEN = 256
DRAFT_K = 4
SELF_TEST_NEW = 20                   # a multiple of DRAFT_K + 1
SPEC_SYNC_NEW = 8                    # the sync spec run: the first request, cut to 8 new
SPEC_SHORT = 2                       # phase 11's shorter spec runs: the trace's first 2
LADDER = ("exact", "approx", "approx_msr")  # phase 12's quality tiers
TIER_MULTIPLIER = "mul8x8_2"         # ... so the MSR rung is mul8x8_msr4
TIER_REQUESTS, SHED_REQUESTS = 8, 12
SHED_DEPTH, SHED_HOLD, SHED_RESTORE = 4, 4, 0.5
LONG_PROMPT, CHUNK, CHUNK_SMALL = 300, 64, 32  # phase 12's chunked prefill
CHUNK_MAX_LEN = 336                  # covers a long prompt + 16 new, whole blocks
WIDE_BUCKETS, WIDE_MAX_LEN = BUCKETS + (256, 512), 544   # the unchunked session's
NEAR_TIE = 1.0                       # logits; the chunk pass and forward differed by up to 0.645
FAMILY_ARCHS = ("qwen2-moe-a2.7b", "falcon-mamba-7b", "zamba2-2.7b")   # phase 13
FAMILY_REQUESTS, FAMILY_BUCKETS = 6, (16, 32)
FAMILY_MAX_LEN = 48                  # 32 prompt + 12 new, whole blocks
MOE_REQUESTS, MOE_NEW = 4, 8         # phase 13's cut of the moe trace
PAPER_BATCH, PAPER_TEST = 64, 256     # Table VIII's training and test batches
RESNET_STEPS = 3
POOL_WORKERS = 4                     # processes that run phases 8-15's units
TEMP_TOL = (0.02, 1 << 18)           # phase 16: counted temporaries vs measured, rel + bytes
BACKBONE_ARCHS = ("qwen2-vl-2b", "musicgen-large")                    # phase 15
BACKBONE_SEQ = 32                    # phase 15's embeddings per row: 8 text, a 4 x 4 image, 8
TRAIN_STEPS_FAMILY = 2               # phases 14 and 15's steps through K1
TRAIN_DEPTHS = {                     # phases 14 and 15: each model's trained depth (PERF.md 4)
    "qwen2-moe-a2.7b": 1, "falcon-mamba-7b": 2, "zamba2-2.7b": 6,
    "qwen2-vl-2b": 2, "musicgen-large": 2}
TP_DEGREES = (2, 4)                  # phase 17's tensor-parallel ranks
TP4_LAYERS = 4                       # phase 17's tp=4 depth
EP_DEGREES = (2, 4)                  # phase 18's expert-parallel ranks
EP_COLROW_TP = 8                     # phase 18 (a): 60 experts split inside each at this tp
DP = 2                               # phase 19 (b)-(c)'s data-parallel ranks
DP_WORLDS = ("2x1x2", "2", "2x2")    # phase 19's meshes in their order: (f), (b)-(c), (d)
DP_LAYERS = 2                        # phase 19's depth on every mesh (PERF.md 4)
DP_STEPS = 2                         # phase 19's steps per world and reference
DP_LOSS_RTOL = 1e-4                  # phase 19's loss gate: codes flip on the card (DpClose)
SURE_MOVE = {"ssm": 3e-2, "hybrid": 3e-2}   # phase 19 (b): the Mamba families' sure-sign
#   weight move, in lr: the ssm's CPU tolerance (tests/test_torch_train_families.py); their
#   scan parameters' gradients lie near AdamW's eps, where the first move is not saturated
CHUNK_CHECK_S = 4096                 # phase 20 (a): attention_core, chunked vs whole
CHUNK_TOL = 1e-5                     # ... float32 roundoff: the library picks its GEMM by shape
LEVER_MAX_LEN = 32768                # phase 20 (b): one prompt's bucket and max_len
LEVER_NEW = 8                        # ... its new tokens
LEVER_LAYERS = 20                    # ... and its model's depth (PERF.md 4)
LEVER_PROMPT = LEVER_MAX_LEN - 2 * LEVER_NEW   # 32,752 prompt tokens
FUSED_REQUESTS = 2                   # phase 20 (c): phase 4's first requests, fused


_UNIT_LOG = None                     # a pool worker's log lines, printed when its unit ends
_POOL = None                         # a pool worker's unit and the pool's queue
_SEGMENTS = []                       # ... each budget its unit has left and the peak it reserved


def log(*a):
    if _UNIT_LOG is None:
        print(*a, flush=True)
        return
    line = " ".join(map(str, a))
    _UNIT_LOG.append(line)
    print(line[:200], file=sys.stderr, flush=True)      # progress, while the unit runs


def cuda_ms(fn, min_s: float = 0.2, max_reps: int = 50) -> float:
    """Mean device milliseconds per call: warm up, then CUDA events around
    enough back-to-back calls to fill ``min_s``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    reps = int(max(1, min(max_reps, min_s / max(once, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def warm_up(dev, seconds: float = 1.0) -> None:
    """Keep the card busy for a moment so the clocks have ramped up before
    the first timed launch."""
    x = torch.randn(4096, 4096, device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            x = torch.tanh(x @ x)
        torch.cuda.synchronize()


def profile_step(fn, match="approx_matmul_kernel", key="k1_device_ms"):
    """Device time of one call of ``fn`` under torch.profiler: the ms of the
    kernels whose name holds ``match`` (under ``key``; K1's by default),
    all kernels' ms and the top kernels by device time (empty if the
    profiler records no device time).  Only the device's activity is
    recorded: a host op's record costs more than the op (a MoE step's
    tens of thousands of launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0)
    rows = sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0), reverse=True)
    if not rows:
        return {"note": "the profiler recorded no device time"}
    return {key: sum(us for us, _, k in rows if match in k) / 1e3,
            "device_ms": sum(us for us, _, _ in rows) / 1e3,
            "top_device": [{"name": k[:80], "ms": us / 1e3, "calls": c}
                           for us, c, k in rows[:10]]}


# ---------------------------------------------------------------------------
# phase 2: K1
# ---------------------------------------------------------------------------


def exact_int8_ms(a, b):
    """CUDA-event ms of ``torch._int_mm`` on int8 views of the codes: the
    cost of the exact product alone, a yardstick that nothing in the port
    calls; (None, the reason) where the call refuses the shape."""
    a8, b8 = a.view(torch.int8), b.view(torch.int8)
    try:
        return cuda_ms(lambda: torch._int_mm(a8, b8)), None
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:120]


def k1_phase(cfg, params, gen, dev, prefill_rows):
    from repro_torch.core.approx import QWeight
    from repro_torch.core.multipliers import MULTIPLIERS
    from repro_torch.kernels.approx_matmul import approx_matmul, approx_matmul_plain

    def codes(shape, hi):
        return torch.randint(0, hi + 1, shape, generator=gen, device=dev, dtype=torch.uint8)

    def check(M, K, N, mult, rhs_max, timed=False):
        a, b = codes((M, K), 255), codes((K, N), rhs_max)
        out = approx_matmul(a, b, multiplier=mult, rhs_max=rhs_max)
        ref = approx_matmul_plain(a, b, multiplier=mult, rhs_max=rhs_max)
        torch.cuda.synchronize()
        err = (out.long() - ref.long()).abs().max().item()
        if out.dtype != torch.int32 or err != 0:
            bad = (out != ref).sum().item()
            raise AssertionError(f"K1 {mult} M={M} K={K} N={N} rhs_max={rhs_max}: "
                                 f"{bad} of {M * N} outputs differ from the plain version")
        row = {"M": M, "K": K, "N": N, "multiplier": mult, "rhs_max": rhs_max, "max_abs_err": err}
        if timed:
            row["ms"] = cuda_ms(lambda: approx_matmul(a, b, multiplier=mult))
            row["plain_ms"] = cuda_ms(lambda: approx_matmul_plain(a, b, multiplier=mult))
            row["bound_ms"], row["bound_by"] = bound(M * K + K * N + 4 * M * N,
                                                     2.0 * M * N * K, INT8_OPS_PER_S)
            if M > 16:
                row["exact_int8_ms"], why = exact_int8_ms(a, b)
                if why:
                    row["exact_int8_refused"] = why
        log("K1 equal", json.dumps(row))
        return row

    d, hq = cfg.d_model, cfg.num_heads * cfg.head_dim
    hkv, ff, vp = cfg.num_kv_heads * cfg.head_dim, cfg.d_ff, cfg.padded_vocab
    path_kn = sorted({(d, hq), (d, hkv), (hq, d), (d, ff), (ff, d), (d, vp)})
    shapes = [check(M, K, N, "mul8x8_2", 255, timed=True)
              for K, N in path_kn for M in (NUM_SLOTS, prefill_rows)]
    checked = shapes + [check(64, 2048, 2048, mult, rhs_max)
                        for mult in MULTIPLIERS for rhs_max in (255, 31)]
    checked += [check(M, K, N, "mul8x8_3", 255)
                for M, K, N in ((1, 33, 5), (5, 300, 77), (13, 1000, 130), (70, 257, 1000))]
    checked += [check(M, 2048, 512, "mul8x8_2", 255) for M in (16, 32, 63, 64, 65)]

    # one training step's K1 calls at M = batch x seq: each layer's seven
    # projections, again but for w_down in the remat recompute (it stops
    # once the last saved tensor is rebuilt), and the lm_head
    by_kn = {(r["K"], r["N"]): r for r in shapes if r["M"] == prefill_rows}
    layer = [(d, hq), (d, hkv), (d, hkv), (hq, d), (d, ff), (d, ff), (ff, d)]
    calls = [kn for _ in range(cfg.num_layers) for kn in layer]
    if cfg.remat:
        calls += [kn for _ in range(cfg.num_layers) for kn in layer[:-1]]
    calls.append((d, vp))
    train_step = {"calls": len(calls), "M": prefill_rows,
                  "bound_ms": sum(by_kn[kn]["bound_ms"] for kn in calls),
                  "events_ms": sum(by_kn[kn]["ms"] for kn in calls),
                  "plain_ms": sum(by_kn[kn]["plain_ms"] for kn in calls)}
    ops_ms = sum(by_kn[kn]["bound_ms"] for kn in calls if by_kn[kn]["bound_by"] == "operations")
    train_step["bound_by"] = "operations" if 2 * ops_ms >= train_step["bound_ms"] else "bytes"
    log("K1 training step (per-call times at M=%d summed)" % prefill_rows, json.dumps(train_step))

    # one decode step's K1 work on the served model's frozen weights
    lay = params["layers"]
    ws = [w.codes[i] for i in range(cfg.num_layers)
          for w in (lay["attn"]["wq"], lay["attn"]["wk"], lay["attn"]["wv"],
                    lay["attn"]["wo"], lay["ffn"]["w_gate"], lay["ffn"]["w_up"],
                    lay["ffn"]["w_down"])]
    ws.append(params["lm_head"].codes)
    assert all(isinstance(w, torch.Tensor) for w in ws) and isinstance(params["lm_head"], QWeight)
    acts = {K: codes((NUM_SLOTS, K), 255) for K in {w.shape[0] for w in ws}}
    mult = cfg.approx.multiplier

    def step(fn):
        return lambda: [fn(acts[w.shape[0]], w, multiplier=mult) for w in ws]

    nbytes = sum(NUM_SLOTS * w.shape[0] + w.numel() + 4 * NUM_SLOTS * w.shape[1] for w in ws)
    ops = sum(2.0 * NUM_SLOTS * w.numel() for w in ws)
    bms, by = bound(nbytes, ops, INT8_OPS_PER_S)
    per_step = {"calls": len(ws), "M": NUM_SLOTS, "ms": cuda_ms(step(approx_matmul)),
                "plain_ms": cuda_ms(step(approx_matmul_plain)), "bound_ms": bms,
                "bound_by": by}
    # "ms" above includes the host's issue rate (281 wrapper calls); the
    # kernels' own device time under the profiler:
    per_step["device_ms"] = profile_step(step(approx_matmul)).get("k1_device_ms")
    log("K1 decode step", json.dumps(per_step))
    return shapes, checked, per_step, train_step


# ---------------------------------------------------------------------------
# phase 3: K2
# ---------------------------------------------------------------------------


def paged_case(rng, dev, B, W, bs, n_kv, g, hd, *, holes=False, pool_dtype=torch.float32):
    """Random paged decode inputs: each row holds a random number of
    distinct blocks (possibly none: an all-sentinel row) and its cur_len
    lands in its last block (offset 0 included); ``holes`` knocks an
    allocated middle block back to the sentinel.  The pools and the new
    token's K/V are in ``pool_dtype``, q in float32."""
    H = n_kv * g
    nb = B * W + 1
    f = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32, device=dev)
    q = f(B, H, hd)
    kn, vn = f(B, n_kv, hd).to(pool_dtype), f(B, n_kv, hd).to(pool_dtype)
    kp, vp = f(nb, bs, n_kv, hd).to(pool_dtype), f(nb, bs, n_kv, hd).to(pool_dtype)
    tbl = np.full((B, W), nb, np.int32)
    cur = np.zeros((B,), np.int32)
    free = list(rng.permutation(nb))
    for b in range(B):
        n_alloc = int(rng.integers(0, W + 1))
        tbl[b, :n_alloc] = [free.pop() for _ in range(n_alloc)]
        if n_alloc:
            cur[b] = int(rng.integers((n_alloc - 1) * bs, n_alloc * bs))
            if holes and n_alloc > 1:
                tbl[b, int(rng.integers(0, n_alloc - 1))] = nb
        else:
            cur[b] = int(rng.integers(0, W * bs))
    as_i32 = lambda x: torch.as_tensor(x, dtype=torch.int32, device=dev)
    return [q, kn, vn, kp, vp, as_i32(tbl), as_i32(cur)]


def k2_check(name, args, bs, zero_rows=()):
    """K2 against its plain version on one case, with the query as given
    (if f32) and rounded to bf16 (as served); returns (the worst f32-query
    error, the bf16-query error).  Each f32-query output is within K2_TOL
    of the plain version's.  The bf16-query output is within K2_TOL plus
    bf16's rounding of |ref|, and bit-equal to the output for the same
    query upcast to f32 (exact) rounded to bf16: a kernel that reads a bf16
    q or rounds its output wrongly fails.  All-sentinel rows are exactly 0."""
    from repro_torch.kernels.paged_attention import paged_attention, paged_attention_plain

    q, rest = args[0], args[1:]
    q16 = q.to(torch.bfloat16)
    qs = ([q] if q.dtype == torch.float32 else []) + [q16.float()]
    outs = [paged_attention(x, *rest, block_size=bs) for x in qs]
    refs = [paged_attention_plain(x, *rest, block_size=bs) for x in qs]
    out16 = paged_attention(q16, *rest, block_size=bs)
    torch.cuda.synchronize()
    err = max((o - r).abs().max().item() for o, r in zip(outs, refs))
    if not err <= K2_TOL:
        raise AssertionError(f"K2 {name}: max abs err {err} > {K2_TOL}")
    dev16 = (out16.float() - refs[-1]).abs()
    err16 = dev16.max().item()
    if out16.dtype != torch.bfloat16 or not bool(
            (dev16 <= K2_TOL + refs[-1].abs() * 2.0 ** -8).all()):
        raise AssertionError(f"K2 {name}, bf16 q: {out16.dtype} output, max abs err {err16} "
                             f"beyond {K2_TOL} plus bf16 rounding")
    if not torch.equal(out16, outs[-1].to(torch.bfloat16)):
        raise AssertionError(f"K2 {name}: the bf16-query output is not the f32 result "
                             "rounded to bf16")
    for o in outs + [out16]:
        for b in zero_rows:
            if not torch.equal(o[b], torch.zeros_like(o[b])):
                raise AssertionError(f"K2 {name}: all-sentinel row {b} is not exactly 0")
    return err, err16


def shared_table(rng, dev, B, W, bs, nb):
    """Prefix sharing: every row's table names the same W - 1 leading
    physical blocks and a tail block of its own, with cur_len at a random
    offset of its tail; (table, cur_len) on the card."""
    perm = rng.permutation(nb)
    tbl = np.empty((B, W), np.int32)
    tbl[:, :W - 1] = perm[:W - 1]
    tbl[:, W - 1] = perm[W - 1:W - 1 + B]
    cur = (W - 1) * bs + rng.integers(0, bs, B)
    as_i32 = lambda x: torch.as_tensor(x, dtype=torch.int32, device=dev)
    return as_i32(tbl), as_i32(cur)


def shared_step_check(cfg, dev, rng):
    """One paged decode step through K2 (``paged_decode_attention``, float
    projections at the served head shape) over rows sharing their leading
    blocks: within K2_TOL of the step through the gather, and the step
    writes each row's cur_len slot and nothing else — the shared blocks'
    bytes are unchanged."""
    from repro_torch.core.approx import ApproxConfig
    from repro_torch.models.attention import paged_decode_attention

    B, W, hkv, hd = NUM_SLOTS, MAX_LEN // BLOCK_SIZE, cfg.num_kv_heads, cfg.head_dim
    H, d, nb = cfg.num_heads, 256, NUM_SLOTS * W
    g = torch.Generator(device=dev).manual_seed(11)
    w = lambda *s: torch.randn(*s, generator=g, device=dev) / math.sqrt(s[0])
    p = {"wq": w(d, H * hd), "wk": w(d, hkv * hd), "wv": w(d, hkv * hd), "wo": w(H * hd, d)}
    x = torch.randn(B, 1, d, generator=g, device=dev)
    tbl, cur = shared_table(rng, dev, B, W, BLOCK_SIZE, nb)
    before = [torch.randn(nb + 1, BLOCK_SIZE, hkv, hd, generator=g, device=dev) for _ in "kv"]
    pools = {impl: [t.clone() for t in before] for impl in ("kernel", "gather")}
    with torch.no_grad():
        outs = {impl: paged_decode_attention(x, p, *pools[impl], tbl, cur, block_size=BLOCK_SIZE,
                                             n_heads=H, n_kv=hkv, cfg=ApproxConfig(mode="float"),
                                             attn_impl=impl) for impl in pools}
    err = (outs["kernel"] - outs["gather"]).abs().max().item()
    written = torch.zeros(nb + 1, BLOCK_SIZE, dtype=torch.bool, device=dev)
    written[tbl[:, W - 1].long(), (cur % BLOCK_SIZE).long()] = True
    same_pools = all(torch.equal(a, b) for a, b in zip(*pools.values()))
    only_slots = all(torch.equal((a != b0).any(-1).any(-1), written)
                     for a, b0 in zip(pools["kernel"], before))
    log(f"K2 decode step over shared blocks: max abs err {err:.3g} vs the gather's step; "
        f"pools equal {same_pools}; only each row's cur_len slot written {only_slots}")
    if not (err <= K2_TOL and same_pools and only_slots):
        raise AssertionError("K2's decode step over shared blocks: "
                             f"err {err}, pools equal {same_pools}, only slots {only_slots}")


def k2_step_inputs(dev, rng, *, calls, B, W, hkv, g, hd, cur, pool_dtype):
    """Operands of ``calls`` K2 calls, each on its own pool (as the layers
    of one decode step are), with a bf16 query as served and rows holding
    the blocks their ``cur`` needs: ([q, kn, vn, kp, vp] stacked by call,
    table and lengths on the card, table and lengths in numpy)."""
    nb, H = B * W, hkv * g
    ops = [torch.randn(calls, B, H, hd, device=dev).to(torch.bfloat16)]
    ops += [torch.randn(calls, *s, device=dev).to(pool_dtype)
            for s in ((B, hkv, hd), (B, hkv, hd), (nb, BLOCK_SIZE, hkv, hd),
                      (nb, BLOCK_SIZE, hkv, hd))]
    cur = np.asarray(cur, np.int32)
    tbl = np.full((B, W), nb, np.int32)
    perm = list(rng.permutation(nb))
    for b in range(B):
        n = min(W, int(cur[b]) // BLOCK_SIZE + 1)
        tbl[b, :n] = [perm.pop() for _ in range(n)]
    return ops, torch.as_tensor(tbl, device=dev), torch.as_tensor(cur, device=dev), tbl, cur


def k2_step_of(fn, ops, tbl_t, cur_t):
    """One step of ``fn`` over every call's operands."""
    return lambda: [fn(*(t[i] for t in ops), tbl_t, cur_t, block_size=BLOCK_SIZE)
                    for i in range(ops[0].shape[0])]


def k2_timed(dev, rng, *, calls, B, W, hkv, g, hd, cur, pool_dtype):
    """Check and time ``calls`` K2 calls (``k2_step_inputs``): every call
    held to its plain version as ``k2_check`` does, then CUDA events around
    back-to-back steps (the wrapper's host time included), the kernel's
    device time under the profiler, the plain version, and SDPA over the
    blocks gathered beforehand (the library yardstick; it never runs in
    the port)."""
    from repro_torch.kernels.paged_attention import paged_attention, paged_attention_plain

    ops, tbl_t, cur_t, tbl, cur = k2_step_inputs(dev, rng, calls=calls, B=B, W=W, hkv=hkv, g=g,
                                                 hd=hd, cur=cur, pool_dtype=pool_dtype)
    q, kp, vp = ops[0], ops[3], ops[4]
    pool = str(pool_dtype).replace("torch.", "")
    errs = [k2_check(f"{pool} pool, W={W}, call {i}", [t[i] for t in ops] + [tbl_t, cur_t],
                     BLOCK_SIZE) for i in range(calls)]
    nb, H = B * W, hkv * g
    S = W * BLOCK_SIZE
    idx = tbl_t.clamp(max=nb - 1).long()
    kg = torch.stack([kp[i][idx].reshape(B, S, hkv, hd) for i in range(calls)]).transpose(2, 3)
    vg = torch.stack([vp[i][idx].reshape(B, S, hkv, hd) for i in range(calls)]).transpose(2, 3)
    kg, vg = kg.contiguous(), vg.contiguous()
    pos = torch.arange(S, device=dev)
    mask = (pos[None, :] <= cur_t[:, None].long())[:, None, None, :]
    q4 = q.to(pool_dtype)[:, :, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library_step():
        return [sdpa(q4[i], kg[i], vg[i], attn_mask=mask, enable_gqa=True) for i in range(calls)]

    valid = k2_valid_positions(tbl, cur, nb, BLOCK_SIZE)
    esize = pool_dtype.itemsize
    bms, by = k2_bound(B, H, hkv, hd, W, valid, 2, esize, calls)
    step = lambda fn: k2_step_of(fn, ops, tbl_t, cur_t)
    prof = profile_step(step(paged_attention), match="paged_attention_kernel",
                        key="device_ms_k2")
    row = {"calls": calls, "B": B, "W": W, "pool": pool,
           "q": "bfloat16", "cur_len": cur.tolist(), "valid_positions": valid,
           "max_abs_err_f32_q": max(e for e, _ in errs),
           "max_abs_err_bf16_q": max(e for _, e in errs),
           "ms": cuda_ms(step(paged_attention)), "device_ms": prof.get("device_ms_k2"),
           "plain_ms": cuda_ms(step(paged_attention_plain)), "bound_ms": bms, "bound_by": by,
           "library_ms": cuda_ms(library_step)}
    for k in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms"):
        if row[k] is not None:
            row[k + "_per_call"] = row[k] / calls
    return row


def k2_phase(cfg, dev, seed):
    rng = np.random.default_rng(seed)
    hkv, g, hd = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.head_dim
    W = MAX_LEN // BLOCK_SIZE
    worst = [0.0, 0.0]

    def check(name, args, bs, zero_rows=()):
        errs = k2_check(name, args, bs, zero_rows)
        worst[:] = [max(a, b) for a, b in zip(worst, errs)]
        log(f"K2 {name}: max abs err {errs[0]:.3g} (f32 q), {errs[1]:.3g} (bf16 q)")

    shapes = [("served", NUM_SLOTS, W, BLOCK_SIZE, hkv, g, hd), ("test", 3, 5, 4, 2, 2, 32),
              ("block1", 2, 6, 1, 2, 3, 16), ("block8", 4, 3, 8, 1, 2, 4)]
    for pool, pool_dtype in K2_POOLS.items():
        for name, B, Wc, bs, n_kv, gg, d in shapes:
            case = lambda **kw: paged_case(rng, dev, B, Wc, bs, n_kv, gg, d,
                                           pool_dtype=pool_dtype, **kw)
            for holes in (False, True):
                check(f"{name} {pool} holes={holes}", case(holes=holes), bs)
            args = case()
            nb = args[3].shape[0]
            args[5][1:] = nb                                      # rows 1.. all sentinel
            check(f"{name} {pool} all-sentinel rows", args, bs, zero_rows=range(1, B))
            args = case()
            args[5] = torch.as_tensor(rng.permutation(nb)[:B * Wc].reshape(B, Wc),
                                      dtype=torch.int32, device=dev)
            args[6] = torch.as_tensor(bs * rng.integers(0, Wc, B), dtype=torch.int32, device=dev)
            check(f"{name} {pool} cur_len on a block boundary", args, bs)
            args[6] = torch.as_tensor(Wc * bs + rng.integers(0, bs + 1, B), dtype=torch.int32,
                                      device=dev)
            check(f"{name} {pool} cur_len past the table", args, bs)
            args = case()
            args[5], args[6] = shared_table(rng, dev, B, Wc, bs, nb)
            check(f"{name} {pool} rows sharing leading blocks", args, bs)
    shared_step_check(cfg, dev, rng)

    # one decode step's K2 work (one call per layer on its own pool, rows at
    # served lengths: a quarter to all of the table), and one call at
    # granite-3.0-2b's context length (four pools, so no call finds its
    # blocks in L2), on each pool dtype; every call checked as above
    cur = rng.integers(MAX_LEN // 4, MAX_LEN, NUM_SLOTS)
    step = {pool: k2_timed(dev, rng, calls=cfg.num_layers, B=NUM_SLOTS, W=W, hkv=hkv, g=g,
                           hd=hd, cur=cur, pool_dtype=dt) for pool, dt in K2_POOLS.items()}
    for pool, row in step.items():
        log(f"K2 decode step, {pool} pool", json.dumps(row))
    long = {pool: k2_timed(dev, rng, calls=4, B=NUM_SLOTS, W=LONG_CONTEXT // BLOCK_SIZE,
                           hkv=hkv, g=g, hd=hd, cur=[LONG_CONTEXT - 1] * NUM_SLOTS,
                           pool_dtype=dt) for pool, dt in K2_POOLS.items()}
    for pool, row in long.items():
        log(f"K2 at {LONG_CONTEXT} positions, {pool} pool", json.dumps(row))
    for row in (*step.values(), *long.values()):
        worst = [max(worst[0], row["max_abs_err_f32_q"]), max(worst[1], row["max_abs_err_bf16_q"])]
    return worst, step, long


# ---------------------------------------------------------------------------
# phases 4-5: serve and oracle
# ---------------------------------------------------------------------------


def make_trace(rng, vocab, n):
    """(prompt, max_new, arrival): the first two arrive at tick 0 and are
    admitted as one batch, the rest arrive over the next ticks."""
    return [(rng.integers(0, vocab, int(rng.integers(16, 129))),
             int(rng.integers(16, MAX_NEW + 1)), 0 if i < 2 else 1 + (i - 2) // 2)
            for i in range(n)]


def serve(cfg, params, trace, dev, attn_impl, seed, cache_layout="paged", loop="sync", **kw):
    """Phase 4's session on ``trace``: (session, results, wall seconds of
    ``run()`` ending in a synchronise).  ``kw`` reaches ``ServeSession``
    (``steps_per_tick``, ``prefill_decode_ratio``)."""
    from repro_torch.serve import ServeSession

    sess = ServeSession(cfg, params, num_slots=NUM_SLOTS, max_len=MAX_LEN,
                        prompt_buckets=BUCKETS, block_size=BLOCK_SIZE, policy="fifo",
                        attn_impl=attn_impl, seed=seed, cache_layout=cache_layout,
                        loop=loop, device=dev, **kw)
    for i, (p, n, a) in enumerate(trace):
        sess.submit(p, max_new=n, arrival=a, req_id=i)
    t0 = time.perf_counter()
    results = sess.run()
    torch.cuda.synchronize()
    return sess, results, time.perf_counter() - t0


def profile_decode(cfg, params, trace, dev, seed, ticks=6, cache_layout="paged", loop="sync"):
    """Where a decode tick's time goes: host-clock ms per tick without the
    profiler, and the kernels' device ms per tick under torch.profiler
    (first four requests resident, no admission in the window; under the
    async loop a tick is one ``step()``: dispatch a chunk, harvest the
    previous one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import ServeSession

    sess = ServeSession(cfg, params, num_slots=NUM_SLOTS, max_len=MAX_LEN,
                        prompt_buckets=BUCKETS, block_size=BLOCK_SIZE, policy="fifo",
                        cache_layout=cache_layout, loop=loop, seed=seed, device=dev)
    for i, (p, n, _) in enumerate(trace[:NUM_SLOTS]):
        sess.submit(p, max_new=n, req_id=i)
    for _ in range(3):                      # admission, then two warm decode ticks
        sess.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        sess.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            sess.step()
        torch.cuda.synchronize()
    # device-side entries only: a CPU op's own device time repeats its kernels'
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0)
    rows = sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0), reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3 / ticks
    out = {"layout": cache_layout, "loop": loop, "ticks": ticks, "n_active": sess.n_active,
           "wall_ms_per_tick": wall_ms,
           "device_ms_per_tick": device_ms,
           "device_idle_share": 1.0 - device_ms / wall_ms if device_ms else None,
           "top_device": [{"name": k[:80], "ms_per_tick": us / 1e3 / ticks,
                           "calls_per_tick": c / ticks} for us, c, k in rows[:12]]}
    if not device_ms:
        out["note"] = "the profiler recorded no device time"
    return out


def decode_step_diff(cfg, params, trace, toks, dev, cache_dtype=torch.float32, near_tie=0.0):
    """Prefill the first two prompts into a fresh pool of ``cache_dtype``,
    then run one decode step on copies of it through K2 and through its
    plain version (K1 in both): the logits' largest difference and whether
    the argmax agrees.  Where it does not, each differing row's two tokens
    must lie within ``near_tie`` in the plain step's logits (recorded)."""
    from repro_torch.models.transformer import forward, init_paged_cache, paged_decode_step
    from repro_torch.serve.cache import scatter_prompt_blocks

    W, nbk = MAX_LEN // BLOCK_SIZE, BUCKETS[-1] // BLOCK_SIZE
    with torch.no_grad():
        cache = init_paged_cache(cfg, 2 * W, BLOCK_SIZE, cache_dtype, device=dev)
        logits, kvs = forward(cfg, params, toks, return_kv=True)
        ids = torch.arange(2 * (nbk + 1), dtype=torch.int32, device=dev).reshape(2, nbk + 1)
        scatter_prompt_blocks(cache, kvs, ids[:, :nbk], BLOCK_SIZE)
        tables = torch.full((2, W), 2 * W, dtype=torch.int32, device=dev)
        tables[:, :nbk + 1] = ids
        lens = torch.as_tensor([trace[0][0].size, trace[1][0].size], device=dev)
        nxt = logits[torch.arange(2, device=dev), lens - 1].argmax(-1)[:, None]
        out = {impl: paged_decode_step(cfg, params, {k: v.clone() for k, v in cache.items()},
                                       nxt, lens, tables, block_size=BLOCK_SIZE,
                                       attn_impl=impl)[:, 0, :cfg.vocab_size]
               for impl in ("kernel", "gather")}
    res = {"pool": str(cache_dtype).replace("torch.", ""),
           "max_abs_diff": (out["kernel"] - out["gather"]).abs().max().item(),
           "max_abs_logit": out["gather"].abs().max().item(),
           "argmax_equal": bool(torch.equal(out["kernel"].argmax(-1), out["gather"].argmax(-1)))}
    if not res["argmax_equal"]:
        a, b = out["kernel"].argmax(-1), out["gather"].argmax(-1)
        res["near_ties"] = [{"row": r, "tokens": [int(a[r]), int(b[r])],
                             "logits": [out["gather"][r, a[r]].item(),
                                        out["gather"][r, b[r]].item()]}
                            for r in (a != b).nonzero()[:, 0].tolist()]
        if any(abs(t["logits"][0] - t["logits"][1]) > near_tie for t in res["near_ties"]):
            raise AssertionError(f"decode step through K2 picks other tokens than the plain "
                                 f"one: {res}")
    return res


# ---------------------------------------------------------------------------
# phase 6: K3
# ---------------------------------------------------------------------------


def k3_phase(dev, gen):
    from repro_torch.core.multipliers import mul8x8_table
    from repro_torch.kernels.approx_matmul import approx_matmul
    from repro_torch.kernels.approx_mul_eltwise import (approx_mul_eltwise,
                                                        approx_mul_eltwise_plain,
                                                        lut_mismatches)

    # the path: K1's all-pairs table checked against the bit logic, one
    # launch per design
    approx_mul_eltwise.launches = 0
    mismatches = {m: lut_mismatches(m, device=dev) for m in K3_DESIGNS}
    torch.cuda.synchronize()
    launches = approx_mul_eltwise.launches
    if any(mismatches.values()) or launches != len(K3_DESIGNS):
        raise AssertionError(f"K3: K1's table differs from the bit logic {mismatches} "
                             f"({launches} launches)")

    codes = torch.arange(256, device=dev, dtype=torch.uint8)
    a, b = codes.repeat_interleave(256), codes.repeat(256)
    checked = 0

    def check(name, x, y, mult, *others):
        nonlocal checked
        out = approx_mul_eltwise(x, y, multiplier=mult)
        want = [approx_mul_eltwise_plain(x, y, mult), *others]
        torch.cuda.synchronize()
        for w in want:
            if out.dtype != torch.int32 or out.shape != x.shape or not torch.equal(out, w):
                bad = (out != w).sum().item() if out.shape == w.shape else "all"
                raise AssertionError(f"K3 {mult} {name}: {bad} of {x.numel()} outputs differ")
        checked += 1
        log(f"K3 equal: {mult} {name} {tuple(x.shape)} {x.dtype}")

    for m in K3_DESIGNS:
        table = torch.from_numpy(mul8x8_table(m).reshape(-1).copy()).to(dev)
        k1_table = approx_matmul(codes[:, None], codes[None, :], multiplier=m).reshape(-1)
        check("all pairs vs plain, table and K1's table", a, b, m, table, k1_table)
        for dtype in (torch.uint8, torch.int32):
            n = 10**6 + 3
            x = torch.randint(0, 256, (n,), generator=gen, device=dev, dtype=dtype)
            y = torch.randint(0, 256, (n,), generator=gen, device=dev, dtype=dtype)
            check("ragged 1-D", x, y, m)
            shape = (3, 17, 65, 129)
            x = torch.randint(0, 256, shape, generator=gen, device=dev, dtype=dtype)
            y = torch.randint(0, 256, shape, generator=gen, device=dev, dtype=dtype)
            check("4-D", x, y, m)
        check("unaligned views", a[1:-3], b[3:-1], m)

    n = K3_TIMED_N
    x = torch.randint(0, 256, (n,), generator=gen, device=dev, dtype=torch.uint8)
    y = torch.randint(0, 256, (n,), generator=gen, device=dev, dtype=torch.uint8)
    check("timed shape", x, y, "mul8x8_2")
    bms, by = bound(6.0 * n, 0.0, INT8_OPS_PER_S)
    timed = {"n": n, "multiplier": "mul8x8_2",
             "ms": cuda_ms(lambda: approx_mul_eltwise(x, y, multiplier="mul8x8_2")),
             "plain_ms": cuda_ms(lambda: approx_mul_eltwise_plain(x, y, "mul8x8_2")),
             "bound_ms": bms, "bound_by": by}
    timed["gb_per_s"] = 6.0 * n / (timed["ms"] * 1e-3) / 1e9
    log(f"K3 timed {json.dumps(timed)}")
    return {"launches": launches, "lut_mismatches": mismatches, "checked": checked,
            "max_abs_err": 0, "timed": timed}


# ---------------------------------------------------------------------------
# phase 7: train
# ---------------------------------------------------------------------------


def train_phase(dev, seed):
    from repro_torch.configs import get_config
    from repro_torch.core.approx import ApproxConfig
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels.approx_matmul import approx_matmul
    from repro_torch.launch import train as launch_train
    from repro_torch.train import optim as O
    from repro_torch.train.loop import as_batch, init_state, make_train_step, train_loop
    from repro_torch.train.tree import leaves, tree_map

    cfg = dataclasses.replace(get_config(ARCH), approx=ApproxConfig(
        multiplier="mul8x8_2", mode="kernel", band_reg=1e-4))
    opt = O.OptConfig(lr=3e-4, total_steps=TRAIN_STEPS)          # as launch/train.py
    out = {"layers": cfg.num_layers, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "k1_M": TRAIN_BATCH * TRAIN_SEQ, "remat": cfg.remat}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(cfg, opt, seed, device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params"] = sum(p.numel() for p in leaves(state["params"]))
    batches = token_batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=seed)

    approx_matmul.launches = 0
    state, hist = train_loop(cfg, opt, batches, steps=TRAIN_STEPS, state=state)
    torch.cuda.synchronize()
    out["launches"] = approx_matmul.launches
    out["losses"], out["step_s"] = hist["loss"], hist["step_time"]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[train] {json.dumps(out)}")
    if not all(math.isfinite(x) for x in hist["loss"]):
        raise AssertionError(f"training losses not finite: {hist['loss']}")
    if out["launches"] <= 0:
        raise AssertionError("approx_matmul was never launched on the training path")

    # where a step's time goes: one more step, counted on meta first, then
    # run with the launch counts zeroed and profiled (phase 16)
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import in_depth
    from repro_torch.launch.roofline import count_costs
    from repro_torch.launch.specs import input_specs, state_specs

    step = make_train_step(cfg, opt)
    shape = ShapeConfig("train_8x64", TRAIN_SEQ, TRAIN_BATCH, "train")
    costs = in_depth(cfg, lambda c: count_costs(make_train_step(c, opt), state_specs(c, opt),
                                                input_specs(c, shape)), peak="backward")["total"]
    out["roofline"] = roofline_step(
        "train", step, costs, (state_specs(cfg, opt), input_specs(cfg, shape)),
        (state, as_batch(next(batches), dev)),
        6.0 * cfg.param_count() * TRAIN_BATCH * TRAIN_SEQ, grad=True)
    out["profiled_step"] = {**out["roofline"].pop("profile"),
                            "k1_launches_per_step": out["launches"] // TRAIN_STEPS}
    log(f"[train] profiled step: {json.dumps(out['profiled_step'])}")
    if not out["profiled_step"].get("k1_device_ms", 0) > 0:
        raise AssertionError("the profiled step shows no device time for approx_matmul_kernel "
                             f"though K1 launched {out['launches']} times")

    # remat off: the same step keeps each layer's activations (about 76 GB
    # at the peak: return the allocator's cached blocks first)
    gc.collect()
    torch.cuda.empty_cache()
    cfg_nr = dataclasses.replace(cfg, remat=False)
    step_nr = make_train_step(cfg_nr, opt)
    times = []
    torch.cuda.reset_peak_memory_stats()
    n0 = approx_matmul.launches
    for _ in range(2):
        batch = as_batch(next(batches), dev)
        t0 = time.perf_counter()
        state, m = step_nr(state, batch)
        float(m["loss"])
        times.append(time.perf_counter() - t0)
    out["remat_off"] = {"step_s": times, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "k1_launches_per_step": (approx_matmul.launches - n0) // 2}
    log(f"[train] remat off: {json.dumps(out['remat_off'])}")
    del state, batch, m
    gc.collect()
    torch.cuda.empty_cache()

    # oracle: one 4-layer step through K1 and through its plain version
    cfg4 = dataclasses.replace(cfg, num_layers=ORACLE_LAYERS)
    s_k = init_state(cfg4, opt, seed + 1, device=dev)
    s_l = tree_map(lambda t: t.detach().clone(), s_k)
    batch = as_batch(next(token_batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                                        seed=seed + 1)), dev)
    n0 = approx_matmul.launches
    s_k, m_k = make_train_step(cfg4, opt)(s_k, batch)
    torch.cuda.synchronize()
    n_k = approx_matmul.launches - n0
    cfg4l = dataclasses.replace(cfg4, approx=dataclasses.replace(cfg4.approx, mode="lowrank"))
    s_l, m_l = make_train_step(cfg4l, opt)(s_l, batch)
    torch.cuda.synchronize()
    if approx_matmul.launches != n0 + n_k or n_k <= 0:
        raise AssertionError(f"oracle launches: kernel step {n_k}, plain step "
                             f"{approx_matmul.launches - n0 - n_k}")
    la, lb = leaves(s_k), leaves(s_l)
    diff = max((x.float() - y.float()).abs().max().item() for x, y in zip(la, lb))
    same = all(torch.equal(x, y) for x, y in zip(la, lb))
    out["oracle"] = {"layers": ORACLE_LAYERS, "loss_kernel": m_k["loss"].item(),
                     "loss_plain": m_l["loss"].item(), "state_identical": same,
                     "max_abs_state_diff": diff, "k1_launches": n_k}
    log(f"[train] oracle: {json.dumps(out['oracle'])}")
    if m_k["loss"].item() != m_l["loss"].item() or not same:
        raise AssertionError("a training step through K1 differs from one through its "
                             f"plain version: {out['oracle']}")
    del s_k, s_l, la, lb
    gc.collect()
    torch.cuda.empty_cache()

    # the launcher at reduced size, then resumed from its checkpoint
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt-")
    try:
        common = ["--reduced", "--ckpt", tmp, "--ckpt-every", "2", "--seed", str(seed)]
        first = launch_train.main(common + ["--steps", "2"])
        second = launch_train.main(common + ["--steps", "4"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launcher"] = {"first_losses": first["losses"], "resumed_at": second["start"],
                       "second_losses": second["losses"]}
    log(f"[train] launcher: {json.dumps(out['launcher'])}")
    if first["start"] != 0 or second["start"] != 2 or len(second["losses"]) != 2 or not all(
            math.isfinite(x) for x in first["losses"] + second["losses"]):
        raise AssertionError(f"the launcher did not resume from its checkpoint: "
                             f"{out['launcher']}")
    return out


# ---------------------------------------------------------------------------
# phase 8: paper
# ---------------------------------------------------------------------------


def cnn_dense_shapes(model, in_shape, batch, dev):
    """(M, K, N) of each dense call of one forward of ``model`` at ``batch``,
    in call order: a float forward with the CNN module's ``dense`` wrapped."""
    from repro_torch.core.approx import ApproxConfig
    from repro_torch.models import cnn

    shapes, real = [], cnn.dense

    def record(x, w, cfg):
        shapes.append((x.numel() // x.shape[-1], x.shape[-1], w.shape[-1]))
        return real(x, w, cfg)

    cnn.dense = record
    try:
        with torch.no_grad():
            cnn.cnn_forward(model, torch.zeros(batch, *in_shape, device=dev),
                            ApproxConfig(mode="float"))
    finally:
        cnn.dense = real
    return shapes


def k1_cnn_shapes(dev, gen, seed):
    """K1 bit-equal to its plain version at every im2col and FC shape of the
    seven Table VIII nets, at the training batch and the test batch
    (mul8x8_2; ResNet-19's shapes at the training batch also for the other
    Table VIII multipliers), and each ResNet-19 shape at the training batch
    timed beside its bound and the plain version."""
    from repro_torch.configs.paper_cnns import CNN_SPECS
    from repro_torch.kernels.approx_matmul import approx_matmul, approx_matmul_plain
    from repro_torch.models.cnn import init_cnn
    from repro_torch.paper.table_viii import MULTIPLIERS

    def codes(shape):
        return torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)

    per_net, todo = {}, {}
    for key, spec in CNN_SPECS.items():
        model = init_cnn(spec.name, seed, in_shape=spec.in_shape, device=dev)
        per_net[key] = {b: cnn_dense_shapes(model, spec.in_shape, b, dev)
                        for b in (PAPER_BATCH, PAPER_TEST)}
        for b, shapes in per_net[key].items():
            for mkn in shapes:
                mults = MULTIPLIERS if (spec.name == "resnet19" and b == PAPER_BATCH) \
                    else ("mul8x8_2",)
                todo.setdefault(mkn, set()).update(mults)
    checked, timed = 0, {}
    resnet = set(per_net["resnet19-cifar10"][PAPER_BATCH])
    for (M, K, N), mults in sorted(todo.items()):
        a, b = codes((M, K)), codes((K, N))
        for mult in sorted(mults):
            out = approx_matmul(a, b, multiplier=mult)
            ref = approx_matmul_plain(a, b, multiplier=mult)
            torch.cuda.synchronize()
            if out.dtype != torch.int32 or not torch.equal(out, ref):
                bad = (out != ref).sum().item()
                raise AssertionError(f"K1 {mult} M={M} K={K} N={N}: {bad} of {M * N} "
                                     "outputs differ from the plain version")
            checked += 1
        del out, ref
        if (M, K, N) in resnet:
            row = {"M": M, "K": K, "N": N,
                   "ms": cuda_ms(lambda: approx_matmul(a, b, multiplier="mul8x8_2")),
                   "plain_ms": cuda_ms(lambda: approx_matmul_plain(a, b, multiplier="mul8x8_2"),
                                       max_reps=5)}
            row["bound_ms"], row["bound_by"] = bound(M * K + K * N + 4 * M * N,
                                                     2.0 * M * N * K, INT8_OPS_PER_S)
            timed[(M, K, N)] = row
            log("K1 ResNet-19 shape", json.dumps(row))
    calls = per_net["resnet19-cifar10"][PAPER_BATCH]
    forward = {"calls": len(calls), "batch": PAPER_BATCH,
               **{k: sum(timed[c][k] for c in calls) for k in ("ms", "plain_ms", "bound_ms")}}
    ops_ms = sum(timed[c]["bound_ms"] for c in calls if timed[c]["bound_by"] == "operations")
    forward["bound_by"] = "operations" if 2 * ops_ms >= forward["bound_ms"] else "bytes"
    log(f"K1 at the CNN shapes: {len(todo)} shapes, {checked} checks bit-equal; ResNet-19 "
        f"forward at batch {PAPER_BATCH} (per-shape times summed): {json.dumps(forward)}")
    return {"shapes": len(todo), "checked": checked, "max_abs_err": 0,
            "resnet19_shapes": list(timed.values()), "resnet19_forward": forward}


def paper_phase(dev, seed):
    """Phase 8 (b)-(e): the paper's experiment through K1 (see the module
    text); (a), ``k1_cnn_shapes``, runs in the parent process."""
    from repro_torch.core.approx import ApproxConfig
    from repro_torch.core.metrics import dal
    from repro_torch.data.synthetic import image_dataset
    from repro_torch.kernels.approx_matmul import approx_matmul
    from repro_torch.models.cnn import cnn_forward, init_cnn
    from repro_torch.paper import table_viii
    from repro_torch.train.tree import leaves, tree_map

    t_phase = time.perf_counter()
    out = {}

    # (b) Table VIII, every multiplier through K1; the count zeroed per net
    rows = []
    for net, ds in table_viii.nets(full=True):
        approx_matmul.launches = 0
        row = table_viii.run_net(net, ds, steps=table_viii.FULL_STEPS, device=dev, seed=seed)
        row["k1_launches"] = approx_matmul.launches
        rows.append(row)
        log(f"[paper] table_viii/{net}-{ds} {row['seconds']:.1f}s float {row['float_acc']:.4f}; "
            + "; ".join(f"{m} {r['acc']:.4f} (DAL {r['dal']:+.4f}) -> retrained "
                        f"{r['retrained_acc']:.4f} (DAL {r['retrained_dal']:+.4f})"
                        for m, r in row["multipliers"].items())
            + f"; K1 launches {row['k1_launches']}")
        if row["k1_launches"] <= 0:
            raise AssertionError(f"table_viii/{net}-{ds}: approx_matmul was never launched")
    out["table_viii"] = rows

    # (c) the JAX system test's assertions at LeNet-MNIST, held on Table
    # VIII's LeNet-MNIST model; the test's own 80-step protocol run beside
    # it and printed (at 80 steps LeNet is mid-way through learning the
    # task and the claim depends on the init: scripts/lenet_claim_seeds.py)
    lenet_row = next(r for r in rows if (r["net"], r["dataset"]) == ("lenet", "mnist"))
    acc = {"float": lenet_row["float_acc"],
           **{m: lenet_row["multipliers"][m]["acc"] for m in ("mul8x8_2", "pkm")}}
    data = table_viii.on_device(image_dataset("mnist", n_train=1024, n_test=256, seed=0), dev)
    approx_matmul.launches = 0
    fl = ApproxConfig(mode="float")
    lenet = table_viii.train(init_cnn("lenet", seed, in_shape=(28, 28, 1), device=dev),
                             data, fl, steps=80)
    mirror = {"float": table_viii.accuracy(lenet, data, fl)}
    for m in ("mul8x8_2", "pkm"):
        mirror[m] = table_viii.accuracy(lenet, data, ApproxConfig(multiplier=m, mode="kernel"))
    holds = lambda a: {"float_above_0.8": a["float"] > 0.8,
                       "mul8x8_2_dal_below_0.08": dal(a["float"], a["mul8x8_2"]) < 0.08,
                       "mul8x8_2_within_0.02_of_pkm": a["mul8x8_2"] >= a["pkm"] - 0.02}
    out["lenet_assertions"] = {"table_viii_model": {"steps": table_viii.FULL_STEPS, "acc": acc,
                                                    "holds": holds(acc)},
                               "mirror_80_steps": {"acc": mirror, "holds": holds(mirror),
                                                   "k1_launches": approx_matmul.launches}}
    log(f"[paper] LeNet-MNIST system-test assertions: {json.dumps(out['lenet_assertions'])}")
    if not all(holds(acc).values()) or approx_matmul.launches <= 0:
        raise AssertionError(f"LeNet-MNIST: {out['lenet_assertions']}")

    # (d) ResNet-19 at full width: a QAT step, its K1 share, inference
    cifar = table_viii.on_device(image_dataset("cifar10", n_train=1024, n_test=PAPER_TEST,
                                               seed=0), dev)
    model = init_cnn("resnet19", seed, device=dev)
    for p in leaves(model["layers"]):
        p.requires_grad_(True)
    qat = ApproxConfig(multiplier="mul8x8_2", mode="kernel")
    xb, yb = cifar["x_train"][:PAPER_BATCH], cifar["y_train"][:PAPER_BATCH]
    xt = cifar["x_test"][:PAPER_TEST]
    res = {"batch": PAPER_BATCH, "params": sum(p.numel() for p in leaves(model["layers"]))}
    approx_matmul.launches = 0
    with torch.no_grad():
        logits = cnn_forward(model, xb, qat)
    torch.cuda.synchronize()
    res["k1_launches_per_forward"] = approx_matmul.launches
    if res["k1_launches_per_forward"] != 21 or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"ResNet-19 forward: {approx_matmul.launches} K1 launches "
                             "(21 expected) or non-finite logits")
    table_viii.sgd_step(model, xb, yb, qat, table_viii.RETRAIN_LR)        # warm
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res["allocated_before_gb"] = torch.cuda.memory_allocated() / 1e9
    steps, losses = [], []
    n0 = approx_matmul.launches
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        losses.append(table_viii.sgd_step(model, xb, yb, qat, table_viii.RETRAIN_LR).item())
        steps.append(time.perf_counter() - t0)
    res.update(qat_step_s=steps, losses=losses,
               k1_launches_per_step=(approx_matmul.launches - n0) // RESNET_STEPS,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    res["profiled_step"] = profile_step(lambda: table_viii.sgd_step(model, xb, yb, qat,
                                                                    table_viii.RETRAIN_LR))
    k1_ms = res["profiled_step"].get("k1_device_ms", 0)
    if k1_ms:
        res["k1_device_share"] = k1_ms / res["profiled_step"]["device_ms"]
    with torch.no_grad():
        infer = lambda: cnn_forward(model, xt, qat)
        res["inference_ms"] = cuda_ms(infer)
    res["images_per_s"] = PAPER_TEST / (res["inference_ms"] / 1e3)
    log(f"[paper] ResNet-19 at batch {PAPER_BATCH}: {json.dumps(res)}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"ResNet-19 QAT losses not finite: {losses}")
    if not k1_ms > 0:
        raise AssertionError("the profiled ResNet-19 step shows no device time for "
                             "approx_matmul_kernel")
    out["resnet19"] = res

    # (e) oracle: K1 against its plain version from identical state and batch
    plain = ApproxConfig(multiplier="mul8x8_2", mode="lowrank")
    n0 = approx_matmul.launches
    with torch.no_grad():
        lk, lp = cnn_forward(model, xt, qat), cnn_forward(model, xt, plain)
    n_fwd = approx_matmul.launches - n0
    copy = lambda: dict(model, layers=tree_map(lambda t: t.detach().clone().requires_grad_(True),
                                               model["layers"]))
    mk, mp = copy(), copy()
    loss_k = table_viii.sgd_step(mk, xb, yb, qat, table_viii.RETRAIN_LR).item()
    loss_p = table_viii.sgd_step(mp, xb, yb, plain, table_viii.RETRAIN_LR).item()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(leaves(mk["layers"]), leaves(mp["layers"])))
    out["oracle"] = {"images": PAPER_TEST, "logits_identical": bool(torch.equal(lk, lp)),
                     "max_abs_logit_diff": (lk - lp).abs().max().item(),
                     "loss_kernel": loss_k, "loss_plain": loss_p, "params_identical": same,
                     "k1_launches": approx_matmul.launches - n0, "k1_launches_forward": n_fwd}
    log(f"[paper] oracle: {json.dumps(out['oracle'])}")
    if not (out["oracle"]["logits_identical"] and loss_k == loss_p and same
            and n_fwd == 21 and approx_matmul.launches - n0 == 42):
        raise AssertionError("ResNet-19 through K1 differs from its plain version: "
                             f"{out['oracle']}")
    del model, mk, mp, lk, lp, logits
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    out["k1_launches_table_viii"] = sum(r["k1_launches"] for r in rows)
    return out


# ---------------------------------------------------------------------------
# phase 9: slots
# ---------------------------------------------------------------------------


def first_divergence(cfg, params, a, b, S0):
    """Where two (B, S0 + n) token runs first part (earliest new position,
    lowest row): the position, both tokens, and the logit gap there in a
    full-sequence forward over ``a``'s prefix (``a``'s token minus ``b``'s)."""
    from repro_torch.models.transformer import forward

    diff = (a[:, S0:] != b[:, S0:]).cpu()
    if not diff.any():
        return None
    pos = int(diff.any(0).nonzero()[0])
    row = int(diff[:, pos].nonzero()[0])
    with torch.no_grad():
        logits = forward(cfg, params, a[row:row + 1, :S0 + pos])[0, -1]
    ta, tb = int(a[row, S0 + pos]), int(b[row, S0 + pos])
    return {"row": row, "new_token_index": pos, "tokens": [ta, tb],
            "logit_gap": (logits[ta] - logits[tb]).item()}


def slots_phase(cfg, ocfg, dev, seed, trace, paged_tokens, smi, profile_paged=None,
                profile=False):
    """Phase 9: the slot layout at full width through K1 (see the module
    text).  ``paged_tokens`` are phase 4's results, by request id."""
    from repro_torch.kernels.approx_matmul import approx_matmul
    from repro_torch.models.transformer import init_params
    from repro_torch.paper.kernel_bench import _decode_bench
    from repro_torch.serve import freeze_params, generate

    t_phase = time.perf_counter()
    params = freeze_params(cfg, init_params(cfg, seed=seed, device=dev))
    next_budget()                       # the float32 weights are gone
    run = dict(max_new=MAX_NEW, max_len=MAX_LEN, device=dev)
    out = {"batch": NUM_SLOTS, "prompt_len": SLOT_PROMPT, "max_new": MAX_NEW,
           "max_len": MAX_LEN}

    # (d) the decode engines at full width, which are also (b)'s legacy run
    # and generate's fused run; every kernel and table is warm by now
    approx_matmul.launches = 0
    engines = {}
    rows = _decode_bench(dev, cfg=cfg, params=params, batch=NUM_SLOTS,
                         prompt_len=SLOT_PROMPT, max_len=MAX_LEN, max_new=MAX_NEW,
                         iters=1, warm=False, outputs=engines)
    launches = n = approx_matmul.launches
    out["decode_bench"] = [{"name": name, "s": us / 1e6, "text": text} for name, us, text in rows]
    for name, us, text in rows:
        log(f"[slots] {name}: {us / 1e6:.3f}s, {text} ({smi})")
    prompts = engines["scan_engine"][:, :SLOT_PROMPT]
    approx_matmul.launches = 0
    toks = {"fused": engines["scan_engine"],
            "decode": generate(cfg, params, prompts, prefill_mode="decode", **run)}
    n_decode = approx_matmul.launches
    launches += n_decode
    out["k1_launches_full_depth"] = {"legacy_and_fused": n, "decode": n_decode}
    if n <= 0 or n_decode <= 0:
        raise AssertionError(f"approx_matmul was never launched by the engines: {n}, {n_decode}")

    # (b) legacy against generate's teacher-forced prefill; fused vs decode
    agree = (toks["fused"] == toks["decode"])[:, SLOT_PROMPT:]
    out["legacy_identical_to_decode"] = torch.equal(engines["legacy_loop"], toks["decode"])
    out["fused_vs_decode"] = {"share_equal": agree.float().mean().item(),
                              "first_divergence": first_divergence(
                                  cfg, params, toks["fused"], toks["decode"], SLOT_PROMPT)}
    log(f"[slots] legacy identical to generate(prefill_mode='decode'): "
        f"{out['legacy_identical_to_decode']}; fused vs decode prefill: "
        f"{json.dumps(out['fused_vs_decode'])}")
    if not out["legacy_identical_to_decode"]:
        raise AssertionError("greedy_generate_legacy differs from generate(prefill_mode='decode')")

    # (a) generate through K1 and through its plain version, both prefills,
    # at full width and ORACLE_LAYERS deep (the plain version's float64
    # products make a 40-layer teacher-forced run cost minutes)
    cfg4 = dataclasses.replace(cfg, num_layers=ORACLE_LAYERS)
    ocfg4 = dataclasses.replace(ocfg, num_layers=ORACLE_LAYERS)
    params4 = freeze_params(cfg4, init_params(cfg4, seed=seed + 1, device=dev))
    for mode in ("fused", "decode"):
        approx_matmul.launches = 0
        got = generate(cfg4, params4, prompts, prefill_mode=mode, **run)
        n = approx_matmul.launches
        launches += n
        plain = generate(ocfg4, params4, prompts, prefill_mode=mode, **run)
        same = torch.equal(got, plain)
        out[f"oracle_{mode}"] = {"layers": ORACLE_LAYERS, "k1_launches": n,
                                 "identical_to_plain": same}
        log(f"[slots] generate prefill={mode}, {ORACLE_LAYERS} layers: K1 launches {n}, "
            f"tokens identical to the plain version's: {same}")
        if not same or n <= 0:
            raise AssertionError(f"generate prefill={mode}: K1 {got[:, SLOT_PROMPT:]} vs "
                                 f"plain {plain[:, SLOT_PROMPT:]}; K1 launches {n}")
    del params4

    # (c) phase 4's trace on the slot layout; the first two requests alone
    approx_matmul.launches = 0
    sess, results, wall = serve(cfg, params, trace, dev, None, seed, cache_layout="slots")
    n = approx_matmul.launches
    launches += n
    st = sess.stats
    generated = sum(len(r.tokens) for r in results.values())
    out["session"] = {"requests": len(results), "generated_tokens": generated, "wall_s": wall,
                      "tok_per_s": generated / wall, "ttft_p50_s": st.ttft_s_p50,
                      "ttft_p50_ticks": st.ttft_p50, "ticks": st.ticks, "k1_launches": n,
                      "attn_impl": st.attn_impl}
    log(f"[slots] session on the slot layout ({smi}): {json.dumps(out['session'])}")
    if n <= 0:
        raise AssertionError("approx_matmul was never launched by the slot session")
    # the layouts held against each other with one attention arithmetic:
    # the slot layout attends with the plain attention_core, so the paged
    # session attends through K2's plain version here.  Against phase 4
    # (K2), whose f32 online softmax sums in another order, a token may
    # flip where two logits tie to a bf16 step; those are reported, and
    # phase 5 holds K2 against its plain version
    _, gathered, _ = serve(cfg, params, trace, dev, "gather", seed)
    for rid, r in gathered.items():
        got, want = results[rid].tokens.tolist(), r.tokens.tolist()
        if got != want:
            raise AssertionError(f"request {rid}: slots {got} vs paged (plain attention) {want}")
    vs_k2 = {rid: [i for i, (a, b) in enumerate(zip(results[rid].tokens.tolist(), want))
                   if a != b] for rid, want in paged_tokens.items()}
    out["session"]["differ_from_phase4_k2"] = {rid: ix for rid, ix in vs_k2.items() if ix}
    log(f"[slots] identical to the paged session through K2's plain version (all "
        f"{len(gathered)} requests); new-token indices that differ from phase 4's K2 "
        f"session: {json.dumps(out['session']['differ_from_phase4_k2'])}")
    for rid in (0, 1):
        p, m, _ = trace[rid]
        alone = generate(cfg, params, p[None, :].astype(np.int32), max_new=m, max_len=MAX_LEN,
                         device=dev)[0, p.size:].tolist()
        log(f"[slots] request {rid}: session {results[rid].tokens.tolist()}")
        log(f"[slots] request {rid}: alone   {alone}")
        if alone != results[rid].tokens.tolist():
            raise AssertionError(f"request {rid}: the slot session differs from generate alone")
    out["session"]["identical_to_paged_plain"] = True
    out["session"]["first_two_equal_generate_alone"] = True

    if profile:
        prof = profile_decode(cfg, params, trace, dev, seed, cache_layout="slots")
        out["profile"] = prof
        log(f"[slots] steady decode tick ({smi}): slots {prof['wall_ms_per_tick']:.2f} host ms, "
            f"idle {prof['device_idle_share']}; paged (phase 4) "
            f"{profile_paged['wall_ms_per_tick']:.2f} host ms, idle "
            f"{profile_paged['device_idle_share']}")
    del params, sess
    gc.collect()
    torch.cuda.empty_cache()
    out["k1_launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 10: async
# ---------------------------------------------------------------------------


def serve_numbers(sess, results, wall):
    """The timings phase 10 reports for one served trace."""
    st = sess.stats
    generated = sum(len(r.tokens) for r in results.values())
    return {"generated_tokens": generated, "wall_s": wall, "tok_per_s": generated / wall,
            "ttft_p50_s": st.ttft_s_p50, "ttft_p50_ticks": st.ttft_p50, "ticks": st.ticks,
            "host_block_s": st.host_block_s, "step_wall_s": st.wall_s,
            "overlap_fraction": st.overlap_fraction,
            "max_decode_gap_ticks": st.max_decode_gap_ticks,
            "prefill_stall_ticks": st.prefill_stall_ticks}


def verify_check(cfg, params, trace, phase4, dev):
    """(d): the multi-token paged pass at full width through K1.  Four of
    phase 4's prompts prefilled into a pool; ``paged_verify_step`` over the
    first VERIFY_S tokens each request generated must equal as many
    sequential ``paged_decode_step(attn_impl="gather")`` calls bit for bit,
    logits and pool.  Then a CHUNK_PROMPT-token prompt through
    ``paged_chunk_prefill_step`` in chunks of PREFILL_CHUNK must equal one
    ``paged_verify_step`` over it bit for bit; its gap to ``forward``'s
    logits is printed (the JAX package's own chunked-vs-fused pin is red)."""
    from repro_torch.kernels.approx_matmul import approx_matmul
    from repro_torch.models.transformer import (forward, init_paged_cache,
                                                paged_chunk_prefill_step, paged_decode_step,
                                                paged_verify_step)
    from repro_torch.serve.cache import scatter_prompt_blocks

    W, nbk, B = MAX_LEN // BLOCK_SIZE, BUCKETS[-1] // BLOCK_SIZE, NUM_SLOTS
    out = {"rows": B, "S": VERIFY_S}
    approx_matmul.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        prompts = np.zeros((B, BUCKETS[-1]), np.int32)
        for i in range(B):
            prompts[i, :trace[i][0].size] = trace[i][0]
        pool = init_paged_cache(cfg, B * W, BLOCK_SIZE, device=dev)
        _, kvs = forward(cfg, params, torch.as_tensor(prompts, device=dev), return_kv=True)
        tables = torch.arange(B * W, dtype=torch.int32, device=dev).reshape(B, W)
        scatter_prompt_blocks(pool, kvs, tables[:, :nbk], BLOCK_SIZE)
        cur = torch.as_tensor([trace[i][0].size for i in range(B)], device=dev)
        toks = torch.as_tensor([phase4["results"][i][0][:VERIFY_S] for i in range(B)],
                               device=dev)
        one = {k: v.clone() for k, v in pool.items()}
        lv = paged_verify_step(cfg, params, one, toks, cur, tables, block_size=BLOCK_SIZE)
        ls = torch.cat([paged_decode_step(cfg, params, pool, toks[:, j:j + 1], cur + j, tables,
                                          block_size=BLOCK_SIZE, attn_impl="gather")
                        for j in range(VERIFY_S)], dim=1)
        out["logits_identical"] = torch.equal(lv, ls)
        out["pool_identical"] = all(torch.equal(one[k], pool[k]) for k in ("k", "v"))
        out["max_abs_diff"] = (lv - ls).abs().max().item()
        del one, pool, kvs, lv, ls
        out["verify_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        rng = np.random.default_rng(CHUNK_PROMPT)
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, CHUNK_PROMPT)), device=dev)
        nb = CHUNK_PROMPT // BLOCK_SIZE
        full = torch.arange(nb, dtype=torch.int32, device=dev)[None, :]
        one = init_paged_cache(cfg, nb, BLOCK_SIZE, device=dev)
        lo = paged_verify_step(cfg, params, one, prompt, torch.zeros(1, dtype=torch.int64,
                                                                     device=dev),
                               full, block_size=BLOCK_SIZE)
        chunked = init_paged_cache(cfg, nb, BLOCK_SIZE, device=dev)
        parts = []
        for pos in range(0, CHUNK_PROMPT, PREFILL_CHUNK):
            # the table grows chunk by chunk; its tail stays the sentinel
            upto = (pos + PREFILL_CHUNK) // BLOCK_SIZE
            tbl = torch.where(torch.arange(nb, device=dev)[None, :] < upto, full, nb)
            parts.append(paged_chunk_prefill_step(
                cfg, params, chunked, prompt[:, pos:pos + PREFILL_CHUNK],
                torch.full((1,), pos, dtype=torch.int64, device=dev), tbl.int(),
                block_size=BLOCK_SIZE))
        lc = torch.cat(parts, dim=1)
        fused = forward(cfg, params, prompt)
        V = cfg.vocab_size
        out["chunk"] = {
            "prompt": CHUNK_PROMPT, "chunk": PREFILL_CHUNK,
            "logits_identical": torch.equal(lc, lo),
            "pool_identical": all(torch.equal(one[k][:, :nb], chunked[k][:, :nb])
                                  for k in ("k", "v")),
            "vs_forward_max_abs_diff": (lo[..., :V] - fused[..., :V]).abs().max().item(),
            "vs_forward_top1_agree": (lo[..., :V].argmax(-1)
                                      == fused[..., :V].argmax(-1)).float().mean().item(),
            "seconds": time.perf_counter() - t0}
    out["k1_launches"] = approx_matmul.launches
    ok = (out["logits_identical"] and out["pool_identical"]
          and out["chunk"]["logits_identical"] and out["chunk"]["pool_identical"])
    log(f"[async] verify and chunk prefill, {json.dumps(out)}")
    if not ok or out["k1_launches"] <= 0:
        raise AssertionError(f"the multi-token pass is not bit-equal to its oracles: {out}")
    return out


_BLOCKING_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                   "cudaMemcpy", "cudaMemcpyAsync")


def stall_probe(cfg, params, trace, dev, seed):
    """Does the host wait on the device where the async loop must not?
    Each case runs while a STALL_MS device stall (``torch.cuda._sleep``,
    longer than a host tick) sits queued ahead of it; the host ms each case
    takes are reported beside the stall's measured ms:

    - ``launch_queue``: tiny kernels launched one by one until a launch
      blocks: how far the host can run ahead of a busy device at all;
    - ``stage_pinned`` (``ServeSession._h2d``: pinned buffer, non-blocking
      copy) against ``stage_pageable`` (``torch.as_tensor(numpy,
      device=cuda)``, which waits for the stream to drain);
    - ``fetch_event`` (``_HostCopy``: non-blocking copy into a pinned
      buffer, an event) against ``fetch_cpu`` (``.cpu()``);
    - ``attention_core`` at phase 4's prefill shape;
    - one ``step()`` of each loop with four requests resident, under the
      profiler: its host ms, its ms in ``cudaLaunchKernel`` and in the
      runtime calls that wait (``_BLOCKING_CALLS``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.attention import attention_core
    from repro_torch.serve import ServeSession
    from repro_torch.serve.scheduler import _HostCopy

    def sessions():
        out = {}
        for loop in ("sync", "async"):
            sess = ServeSession(cfg, params, num_slots=NUM_SLOTS, max_len=MAX_LEN,
                                prompt_buckets=BUCKETS, block_size=BLOCK_SIZE, policy="fifo",
                                loop=loop, seed=seed, device=dev)
            for i, (p, n, _) in enumerate(trace[:NUM_SLOTS]):
                sess.submit(p, max_new=n, req_id=i)
            for _ in range(3):
                sess.step()
            out[loop] = sess
        torch.cuda.synchronize()
        return out

    sess = sessions()                       # the clocks are up by now
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10 ** 8)
    end.record()
    torch.cuda.synchronize()
    cycles = int(STALL_MS * 10 ** 8 / start.elapsed_time(end))

    def stalled(fn):
        """(host ms of fn, the stall's device ms, fn's result)"""
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        t0 = time.perf_counter()
        res = fn()
        ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        return ms, start.elapsed_time(end), res

    out = {}
    x = torch.zeros(1, device=dev)

    def launch_until_blocked():
        n, t_last = 0, time.perf_counter()
        while n < 100_000:
            x.add_(1)
            n += 1
            t = time.perf_counter()
            if t - t_last > 0.05 * STALL_MS / 1e3:
                return n
            t_last = t
        return n

    ms, stall, n = stalled(launch_until_blocked)
    out["launch_queue"] = {"kernels_before_block": n, "host_ms": ms, "stall_ms": stall}
    cur = sess["async"]._cur_len
    q = torch.randn(1, BUCKETS[0], cfg.num_heads, cfg.head_dim, device=dev,
                    dtype=getattr(torch, cfg.dtype))
    kv = torch.randn(1, BUCKETS[0], cfg.num_kv_heads, cfg.head_dim, device=dev,
                     dtype=getattr(torch, cfg.dtype))
    on_dev = torch.zeros(NUM_SLOTS, dtype=torch.int64, device=dev)
    for name, fn in (("stage_pinned", lambda: sess["async"]._h2d(cur)),
                     ("stage_pageable", lambda: torch.as_tensor(cur, device=dev)),
                     ("fetch_event", lambda: _HostCopy(on_dev)),
                     ("fetch_cpu", lambda: on_dev.cpu()),
                     ("attention_core", lambda: attention_core(q, kv, kv, causal=True))):
        ms, stall, _ = stalled(fn)
        out[name] = {"host_ms": ms, "stall_ms": stall}
    sess["async"]._staged.clear()
    for loop, s in sess.items():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            b0 = s.stats.host_block_s
            ms, stall, _ = stalled(s.step)
        self_ms = {}
        for e in prof.key_averages():
            self_ms[e.key] = self_ms.get(e.key, 0.0) + e.self_cpu_time_total / 1e3
        out[f"step_{loop}"] = {
            "host_ms": ms, "stall_ms": stall,
            "host_block_ms": (s.stats.host_block_s - b0) * 1e3,
            "launch_ms": self_ms.get("cudaLaunchKernel", 0.0),
            "waiting_calls_ms": sum(self_ms.get(k, 0.0) for k in _BLOCKING_CALLS)}
    return out


def stall_check(cfg, params, trace, dev, seed, smi):
    """Phase 10 (e): work queued behind a device stall; what the async loop
    does must not wait on it.  Run with nothing else on the card: its gates
    are host times."""
    t0 = time.perf_counter()
    probe = stall_probe(cfg, params, trace, dev, seed)
    for name, row in probe.items():
        log(f"[async] behind a queued {STALL_MS} ms device stall, {name} ({smi}): "
            f"{json.dumps(row)}")
    waits = {name: probe[name]["host_ms"] for name in ("stage_pinned", "fetch_event",
                                                        "attention_core")}
    waits["step_async waiting calls"] = probe["step_async"]["waiting_calls_ms"]
    if probe["stage_pageable"]["host_ms"] < 0.5 * STALL_MS:
        raise AssertionError(f"a pageable copy did not wait out the stall: the probe measured "
                             f"nothing ({probe['stage_pageable']})")
    if max(waits.values()) > 0.25 * STALL_MS:
        raise AssertionError(f"the async path waited on the device: {waits}")
    return probe, time.perf_counter() - t0


def async_phase(cfg, dev, seed, trace, phase4, smi, profile_paged=None, profile=False):
    """Phase 10: the async loop and the multi-token paged pass at full width
    through K1 and K2 (see the module text).  ``phase4`` holds phase 4's
    sync results and ticks."""
    from repro_torch.kernels.approx_matmul import approx_matmul
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import freeze_params

    t_phase = time.perf_counter()
    params = freeze_params(cfg, init_params(cfg, seed=seed, device=dev))
    next_budget()                       # the float32 weights are gone
    want = phase4["results"]
    out = {"timings": {}, "seconds_by_part": {}}
    t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        out["seconds_by_part"][name] = now - t_part
        t_part = now

    def same_tokens(name, results):
        for rid, r in results.items():
            if r.tokens.tolist() != want[rid][0]:
                raise AssertionError(f"{name}: request {rid} {r.tokens.tolist()} vs phase 4's "
                                     f"sync run {want[rid][0]}")

    # the sync loop again, for timings in turn with the async runs
    sess, results, wall = serve(cfg, params, trace, dev, "kernel", seed, loop="sync")
    same_tokens("sync", results)
    out["timings"]["sync"] = serve_numbers(sess, results, wall)

    # (a) the async loop on phase 4's trace
    approx_matmul.launches = paged_attention.launches = 0
    sess, results, wall = serve(cfg, params, trace, dev, "kernel", seed, loop="async")
    out["launches"] = {"approx_matmul": approx_matmul.launches,
                       "paged_attention": paged_attention.launches}
    out["timings"]["async"] = serve_numbers(sess, results, wall)
    same_tokens("async", results)
    late = {rid: r.finished_tick - want[rid][2] for rid, r in results.items()}
    out["finished_ticks_after_sync"] = late
    for rid, r in results.items():
        if r.admitted_tick != want[rid][1] or late[rid] not in (0, 1):
            raise AssertionError(f"async request {rid}: admitted {r.admitted_tick}, finished "
                                 f"{r.finished_tick} vs sync {want[rid][1:]}")
    if sess.stats.ticks != phase4["ticks"]:
        raise AssertionError(f"async ticks {sess.stats.ticks} vs sync {phase4['ticks']}")
    for name, n in out["launches"].items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the async path")
    log(f"[async] async loop ({smi}): tokens, admission ticks and {sess.stats.ticks} ticks "
        f"equal to phase 4's sync run; finish ticks after sync's: {json.dumps(late)}; "
        f"launches {json.dumps(out['launches'])}")

    # (b) four decode steps per chunk; (c) the prefill-decode ratio
    for name, kw in (("async_x4", dict(steps_per_tick=4)),
                     ("async_ratio_1.0", dict(prefill_decode_ratio=1.0))):
        sess, results, wall = serve(cfg, params, trace, dev, "kernel", seed, loop="async", **kw)
        same_tokens(name, results)
        out["timings"][name] = serve_numbers(sess, results, wall)
    gap, steps = out["timings"]["async_ratio_1.0"]["max_decode_gap_ticks"], 1
    if gap > steps + math.ceil(1.0 * steps):
        raise AssertionError(f"ratio 1.0: decode gap {gap} > {steps + math.ceil(steps)}")
    for name, row in out["timings"].items():
        log(f"[async] {name} ({smi}): {json.dumps(row)}")
    part("sessions")

    # (e), the stall probe, runs alone in the parent process: ``stall_check``

    # (d) the multi-token paged pass
    out["verify"] = verify_check(cfg, params, trace, phase4, dev)
    part("verify")

    if profile:
        # in turn, so that a slow spell of the host does not read as a loop's cost
        out["profile"] = [profile_decode(cfg, params, trace, dev, seed, loop=loop)
                          for loop in ("sync", "async", "async", "sync")]
        for prof in out["profile"]:
            log(f"[async] steady {prof['loop']} tick ({smi}): {prof['wall_ms_per_tick']:.2f} "
                f"host ms, idle {prof['device_idle_share']}")
        log(f"[async] phase 4's sync tick: {profile_paged['wall_ms_per_tick']:.2f} host ms, "
            f"idle {profile_paged['device_idle_share']}")
        part("profile")
    del params, sess
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 11: share
# ---------------------------------------------------------------------------


def same_tokens(name, got, want):
    """Raise unless two token streams are equal."""
    if list(got) != list(want):
        raise AssertionError(f"{name}: {list(got)} vs {list(want)}")


def share_session(cfg, params, dev, seed, **kw):
    """Phase 11's ``ServeSession``: 4 slots, 16-row blocks, the async loop
    through K2 unless ``kw`` says otherwise."""
    from repro_torch.serve import ServeSession

    kw = {"num_slots": NUM_SLOTS, "max_len": MAX_LEN, "prompt_buckets": BUCKETS,
          "block_size": BLOCK_SIZE, "policy": "fifo", "seed": seed, "device": dev,
          "loop": "async", "attn_impl": "kernel", **kw}
    return ServeSession(cfg, params, **kw)


def drive(sess, trace, first_id=0):
    """Serve ``trace`` ((prompt, max_new, arrival[, tier]), request ids
    from ``first_id``): the results and the wall seconds of ``run()``
    ending in a synchronise."""
    for i, (p, n, a, *tier) in enumerate(trace):
        sess.submit(p, max_new=n, arrival=a, req_id=first_id + i,
                    tier=tier[0] if tier else None)
    t0 = time.perf_counter()
    res = sess.run()
    torch.cuda.synchronize()
    if not sess.drained or len(res) != len(trace):
        raise AssertionError(f"served {sorted(res)} of {len(trace)} requests")
    return res, time.perf_counter() - t0


def pool_clean(sess):
    """The drained pool: cache-pinned blocks at refcount 1, every other
    block free, tables at the sentinel, no reservation, no replay pending."""
    cached = set(sess._prefix.lru_blocks()) if sess._prefix is not None else set()
    bad = [b for b in range(sess.num_blocks) if sess.blocks.refcount(b) != (b in cached)]
    ok = (not bad and sess.blocks.free_count == sess.num_blocks - len(cached)
          and sess._reserved_total == 0 and not (sess._future != 0).any()
          and (sess._tables == sess.num_blocks).all() and not any(sess._held)
          and not sess._preempt_resume)
    if not ok:
        raise AssertionError(f"the drained pool is not clean: refcounts off at {bad}, "
                             f"{sess.blocks.free_count} free of {sess.num_blocks}, "
                             f"{len(cached)} cached, reserved {sess._reserved_total}")
    return len(cached)


def capture_prefix(sess, nblk):
    """Copy each admitted request's first ``nblk`` blocks (K and V, every
    layer) just after its admission, queued behind its prefill: the K/V
    its table maps there, written by its own prefill or by a sharer's."""
    kv, inner = {}, sess._admit_many

    def admit(reqs):
        inner(reqs)
        for r in reqs:
            slot = next(s.slot for s in sess._active if s is not None and s.req is r)
            held = sess._held[slot][:nblk]
            kv[r.req_id] = torch.stack([torch.stack([sess.cache[n][:, b] for b in held])
                                        for n in ("k", "v")])

    sess._admit_many = admit
    return kv


def record_preemptions(sess):
    """(request id, accepted tokens at the eviction) of each preemption:
    where a victim's stream is cut into the segments phase 11 gates."""
    log_, inner = [], sess._preempt

    def preempt(state):
        log_.append((state.req.req_id, len(state.tokens)))
        inner(state)

    sess._preempt = preempt
    return log_


def count_launches(out, path, name, run, k1=True, k2=True):
    """``run()`` (one feature session's run) with K1's and K2's counts
    zeroed just before and read just after: its launches, recorded under
    ``out["launches_by_run"]`` and added to ``path``'s tally in
    ``out["launches"]``.  ``k1``/``k2``: the run must launch that kernel."""
    from repro_torch.kernels.approx_matmul import approx_matmul
    from repro_torch.kernels.paged_attention import paged_attention

    approx_matmul.launches = paged_attention.launches = 0
    got = run()
    n = {"approx_matmul": approx_matmul.launches, "paged_attention": paged_attention.launches}
    out["launches_by_run"][f"{path}/{name}"] = n
    tally = out["launches"].setdefault(path, dict.fromkeys(n, 0))
    for (k, v), need in zip(n.items(), (k1, k2)):
        tally[k] += v
        if need and v <= 0:
            raise AssertionError(f"{k} was never launched by {path}/{name}")
    return got


def session_numbers(sess, res, wall):
    """The timings and gauges phases 11 and 12 report for one session."""
    st = sess.stats
    gen = sum(len(r.tokens) for r in res.values())
    return {"tok_per_s": gen / wall, "generated_tokens": gen, "wall_s": wall,
            "ttft_p50_s": st.ttft_s_p50, "ticks": st.ticks, "s_per_tick": wall / max(st.ticks, 1),
            "peak_blocks_in_use": st.peak_blocks_in_use, "peak_active": st.peak_active}


def share_trace(rng, vocab, n=REQUESTS):
    """``n`` requests: one SYSTEM_PROMPT-token system prompt, a unique tail
    of 8-40 tokens each (bucket 128), 16-24 new tokens; arrivals as in
    phase 4's trace."""
    system = rng.integers(0, vocab, SYSTEM_PROMPT)
    return [(np.concatenate([system, rng.integers(0, vocab, int(rng.integers(8, 41)))]),
             int(rng.integers(16, 25)), 0 if i < 2 else 1 + (i - 2) // 2) for i in range(n)]


def share_phase(cfg, dev, seed, trace, smi):
    """Phase 11: prefix sharing, preemption and self-speculative decoding at
    full width through K1 and K2 (see the module text); ``trace`` is phase
    4's."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import freeze_params, resolve_execution_mode

    t_phase = time.perf_counter()
    params = freeze_params(cfg, init_params(cfg, seed=seed, device=dev))
    # ORACLE_LAYERS deep, weights from seed + 1 (as phase 9's oracle): the
    # runs whose reading does not need the full depth
    cfg4 = dataclasses.replace(cfg, num_layers=ORACLE_LAYERS)
    params4 = freeze_params(cfg4, init_params(cfg4, seed=seed + 1, device=dev))
    rng = np.random.default_rng(seed + 11)
    vocab = cfg.vocab_size
    out = {"launches": {}, "launches_by_run": {}, "seconds_by_part": {}}
    t_part = time.perf_counter()

    def counted(path, name, sess, tr, k1=True, k2=True):
        return count_launches(out, path, name, lambda: drive(sess, tr), k1, k2)

    def lap(name):
        nonlocal t_part
        now = time.perf_counter()
        out["seconds_by_part"][name] = now - t_part
        t_part = now

    numbers = session_numbers

    # (a) prefix sharing: a common system prompt, without and with sharing
    nblk = SYSTEM_PROMPT // BLOCK_SIZE
    strace = share_trace(rng, vocab)
    plain = share_session(cfg, params, dev, seed)
    pkv = capture_prefix(plain, nblk)
    pres, pwall = drive(plain, strace)
    sess = share_session(cfg, params, dev, seed, prefix_sharing=True)
    skv = capture_prefix(sess, nblk)
    res, wall = counted("prefix", "sharing", sess, strace)
    out["sharing_off"], out["sharing_on"] = numbers(plain, pres, pwall), numbers(sess, res, wall)
    st = sess.stats
    a = out["prefix"] = {"prefix_hit_blocks": st.prefix_hit_blocks, "cow_forks": st.cow_forks,
                         "peak_blocks_in_use": st.peak_blocks_in_use,
                         "peak_blocks_unshared": plain.stats.peak_blocks_in_use,
                         "cached_blocks_after_drain": pool_clean(sess)}
    pool_clean(plain)
    # each request's first blocks: the K/V its table mapped (a sharer's, on
    # a hit) against what its own prefill wrote in the unshared run
    d = max((skv[i] - pkv[i]).abs().max().item() for i in range(len(strace)))
    a["hit_block_kv_max_abs_diff"], a["kv_max_abs"] = d, max(
        v.abs().max().item() for v in pkv.values())
    a["bit_equal"] = all(res[rid].tokens.tolist() == r.tokens.tolist()
                         for rid, r in pres.items())
    log(f"[share] (a) prefix sharing ({smi}): {json.dumps(a)}; "
        f"on {json.dumps(out['sharing_on'])}; off {json.dumps(out['sharing_off'])}")
    for rid, r in pres.items():
        same_tokens(f"sharing, request {rid} (hit-block K/V max |d| {d})",
                    res[rid].tokens.tolist(), r.tokens.tolist())
    if st.prefix_hit_blocks < (len(strace) - 1) * nblk:
        raise AssertionError(f"{st.prefix_hit_blocks} prefix-hit blocks < "
                             f"{(len(strace) - 1) * nblk}")
    if not st.peak_blocks_in_use < plain.stats.peak_blocks_in_use:
        raise AssertionError(f"sharing held {st.peak_blocks_in_use} blocks at peak, unshared "
                             f"{plain.stats.peak_blocks_in_use}")
    # both runs admit in the same batches, so the bytes agree exactly
    if d != 0:
        raise AssertionError(f"a hit block's K/V differs from the request's own prefill by {d} "
                             f"(max |K/V| {a['kv_max_abs']})")
    # three identical prompts ending in a partial block: the first decode
    # write into the shared tail forks a private copy
    cp = rng.integers(0, vocab, COW_PROMPT)
    ctrace = [(cp, 16, 0)] * 3
    cres, _ = drive(share_session(cfg, params, dev, seed), ctrace)
    s = share_session(cfg, params, dev, seed, prefix_sharing=True)
    sres, _ = counted("prefix", "cow", s, ctrace)
    a["cow"] = {"cow_forks": s.stats.cow_forks, "prefix_hit_blocks": s.stats.prefix_hit_blocks}
    pool_clean(s)
    log(f"[share] (a) identical {COW_PROMPT}-token prompts: {json.dumps(a['cow'])}")
    for rid, r in sres.items():
        same_tokens(f"copy-on-write, request {rid} vs unshared", r.tokens.tolist(),
                    cres[rid].tokens.tolist())
        same_tokens(f"copy-on-write, request {rid} vs request 0", r.tokens.tolist(),
                    sres[0].tokens.tolist())
    if a["cow"]["cow_forks"] < 1:
        raise AssertionError(f"copy-on-write: {a['cow']}")
    del sess, plain, s, skv, pkv
    lap("prefix")

    # (b) preemption: phase 4's first requests in a pool above every single
    # worst case that admits two of the prompts but not two worst cases,
    # against the reservation in the same pool and an unstarved pool
    btrace = trace[:PREEMPT_REQUESTS]
    need = sorted(-(-p.size // BLOCK_SIZE) for p, _, _ in btrace)
    worst = sorted(-(-(p.size + n - 1) // BLOCK_SIZE) for p, n, _ in btrace)
    starved = max(worst[-1], need[0] + need[1]) + 1
    if starved >= worst[0] + worst[1]:
        raise AssertionError(f"no pool starves this trace: needs {need}, worst cases {worst}")
    kw = dict(max_len=PREEMPT_MAX_LEN, prompt_buckets=PREEMPT_BUCKETS)
    roomy = share_session(cfg, params, dev, seed, **kw)
    rres, rwall = drive(roomy, btrace)
    # the reservation's admissions are the same at any depth (no eos)
    reserve = share_session(cfg4, params4, dev, seed, num_blocks=starved, **kw)
    drive(reserve, btrace)
    pool_clean(reserve)
    sess = share_session(cfg, params, dev, seed, num_blocks=starved, preemption=True, **kw)
    events = record_preemptions(sess)
    res, wall = counted("preempt", "preemption", sess, btrace)
    pool_clean(sess)
    b = out["preempt"] = {"num_blocks": starved, "preemptions": sess.stats.preemptions,
                          "events": events, "peak_active": sess.stats.peak_active,
                          "peak_active_reservation": reserve.stats.peak_active,
                          "tok_per_s": numbers(sess, res, wall)["tok_per_s"],
                          "tok_per_s_roomy": numbers(roomy, rres, rwall)["tok_per_s"],
                          "victims": {}}
    if sess.stats.preemptions < 1 or not sess.stats.peak_active > reserve.stats.peak_active:
        raise AssertionError(f"preemption: {json.dumps(b)}")
    for rid in sorted({r for r, _ in events}):
        p, n, _ = btrace[rid]
        toks, want = res[rid].tokens.tolist(), rres[rid].tokens.tolist()
        cuts = [k for r, k in events if r == rid]
        v = b["victims"][rid] = {"preempted_at": cuts}
        same_tokens(f"request {rid} before its preemption", toks[:cuts[0]], want[:cuts[0]])
        for j, k in enumerate(cuts):
            # the replay against a fresh session admitted with its prompt
            eff = np.concatenate([p, np.asarray(toks[:k], p.dtype)])
            end = cuts[j + 1] if j + 1 < len(cuts) else n
            fres, _ = drive(share_session(cfg, params, dev, seed, **kw),
                            [(eff, n - k, 0)], first_id=rid)
            same_tokens(f"request {rid} after replay {j}", toks[k:end],
                        fres[rid].tokens.tolist()[:end - k])
        v["whole_stream_equal_unpreempted"] = toks == want
        if toks != want:
            m = min(len(toks), len(want))
            v["first_divergence"] = first_divergence(
                cfg, params, *(torch.as_tensor(np.concatenate([p, t[:m]])[None], device=dev)
                               for t in (np.asarray(toks), np.asarray(want))), p.size)
    log(f"[share] (b) preemption ({smi}): {json.dumps(b)}")
    del roomy, reserve, sess
    lap("preempt")

    # (c) self-speculative decoding: an integer-exact per-row verifier
    # (exact_quant) drafting through K1 (approx), against the same verifier
    # without spec decode, attending through the gather
    vcfg = dataclasses.replace(cfg, approx=resolve_execution_mode("exact_quant", act_per_row=True))
    spec = dict(spec_decode=True, draft_k=DRAFT_K, draft_mode="approx")
    c = out["spec"] = {}

    def oracle_run(name, vc, prm, tr):
        s = share_session(vc, prm, dev, seed, loop="sync", attn_impl="gather")
        res, wall = drive(s, tr)
        c[name] = numbers(s, res, wall)
        log(f"[share] (c) {name} ({smi}): {json.dumps(c[name])}")
        return res

    def spec_run(name, tr, oracle, vc=vcfg, prm=params, k1=True, k2=True, **skw):
        s = share_session(vc, prm, dev, seed, **{**spec, **skw})
        sres, swall = counted("spec", name, s, tr, k1=k1, k2=k2)
        st = s.stats
        row = c[name] = {
            **numbers(s, sres, swall), "accept_rate": st.accept_rate,
            "draft_tokens": st.draft_tokens, "accepted_tokens": st.accepted_tokens,
            "verify_calls": st.verify_calls,
            "tokens_per_verify": (st.accepted_tokens + st.verify_calls) / st.verify_calls,
            "draft_k_shrinks": st.draft_k_shrinks, "draft_k_grows": st.draft_k_grows,
            "draft_k_current": st.draft_k_current}
        log(f"[share] (c) spec {name} ({smi}): {json.dumps(row)}")
        # the oracle served the trace's own max_new; compare what both hold
        for rid, r in sres.items():
            m = min(len(r.tokens), len(oracle[rid].tokens))
            same_tokens(f"spec {name}, request {rid} vs the non-spec session",
                        r.tokens.tolist()[:m], oracle[rid].tokens.tolist()[:m])
        return row

    oracle = oracle_run("oracle", vcfg, params, trace)
    spec_run("mul8x8_2_async", trace, oracle, loop="async")
    spec_run("mul8x8_2_sync", [(p, SPEC_SYNC_NEW, a) for p, _, a in trace[:1]], oracle,
             loop="sync")
    # the self-test: the verifier's own mode drafts (with its per-row
    # scales; no K1), so through the gather every drafted token is
    # accepted; through K2 a near tie may reject one
    two = [(p, SELF_TEST_NEW, a) for p, _, a in trace[:2]]
    for attn in ("gather", "kernel"):
        row = spec_run(f"self_test_{attn}", two, oracle, k1=False, k2=attn == "kernel",
                       draft_mode="exact_quant", attn_impl=attn)
        if attn == "gather" and row["accept_rate"] != 1.0:
            raise AssertionError(f"the self-test draft accepted {row['accept_rate']} of its tokens")
    spec_run("dynamic", trace[:1], oracle, dynamic_draft_k=True, draft_window=4)
    # the paper's ordering of error rates, read end to end on two requests,
    # ORACLE_LAYERS deep
    vcfg4 = dataclasses.replace(vcfg, num_layers=ORACLE_LAYERS)
    oracle4 = oracle_run(f"oracle_{ORACLE_LAYERS}_layers", vcfg4, params4, trace[:SPEC_SHORT])
    for mult in ("mul8x8_1", "mul8x8_2", "mul8x8_3"):
        spec_run(f"{mult}_{ORACLE_LAYERS}_layers", trace[:SPEC_SHORT], oracle4, vc=vcfg4,
                 prm=params4, draft_multiplier=mult)
    lap("spec")
    del params, params4
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 12: tiers
# ---------------------------------------------------------------------------


def record_steps(sess, read):
    """``read(sess)`` after every ``step()`` of ``sess``: the list it fills."""
    seen, inner = [], sess.step

    def step():
        out = inner()
        seen.append(read(sess))
        return out

    sess.step = step
    return seen


def runs(xs):
    """[value, repeats] for each run of equal values in ``xs``."""
    out = []
    for x in xs:
        if out and out[-1][0] == x:
            out[-1][1] += 1
        else:
            out.append([x, 1])
    return out


def shed_session(cfg, params, dev, seed, trace):
    """Phase 12 (b)'s shedding session on ``trace`` ((prompt, max_new,
    arrival), every request at the best rung), stepped on until the level
    is restored: (session, results, wall seconds of ``run()``, the shed
    level after every step)."""
    sess = share_session(cfg, params, dev, seed, tiers=LADDER, tier_multiplier=TIER_MULTIPLIER,
                         shed_queue_depth=SHED_DEPTH, shed_hold_steps=SHED_HOLD,
                         shed_restore_fraction=SHED_RESTORE)
    levels = record_steps(sess, lambda s: s.stats.shed_level)
    res, wall = drive(sess, trace)
    for _ in range(2 * SHED_HOLD * len(LADDER)):     # restoring takes healthy steps
        sess.step()
    return sess, res, wall, levels


def shed_schedule(sess, res, levels):
    """What phase 12 (b) holds the card to: shape-only, so the reduced
    session on the CPU gives it exactly."""
    st = sess.stats
    return {"tier_demotions": st.tier_demotions, "tier_restorations": st.tier_restorations,
            "shed_level": st.shed_level, "tiers": {rid: r.tier for rid, r in sorted(res.items())},
            "levels": runs(levels), "ticks": st.ticks}


def tier_traces(seed, vocab):
    """Phase 12's requests: (a)'s mixed-tier trace, (b)'s burst and (c)'s two
    long prompts, drawn in that order from one generator."""
    rng = np.random.default_rng(seed + 12)
    # (a) mixed tiers: rungs round-robin, the last request at the best rung
    atrace = [(rng.integers(0, vocab, int(rng.integers(16, 65))), int(rng.integers(8, 17)),
               i // 2, None if i == TIER_REQUESTS - 1 else LADDER[i % len(LADDER)])
              for i in range(TIER_REQUESTS)]
    # (b) a burst of requests at the best rung
    btrace = [(rng.integers(0, vocab, int(rng.integers(16, 65))), int(rng.integers(8, 17)),
               i * 2 // SHED_REQUESTS) for i in range(SHED_REQUESTS)]
    long_prompts = [rng.integers(0, vocab, LONG_PROMPT) for _ in range(2)]
    return atrace, btrace, long_prompts


def tiers_phase(cfg, dev, seed, trace, smi):
    """Phase 12 (a) and (b): quality tiers and the load shedder at full width,
    FEATURE_LAYERS deep (their gates are exact), through K1 and K2 (see the
    module text); (c) is ``chunked_phase``."""
    from repro_torch.configs import reduced_config
    from repro_torch.kernels.approx_matmul import approx_matmul
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import resolve_execution_mode

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(cfg, num_layers=FEATURE_LAYERS)
    params = init_params(cfg, seed=seed, device=dev)      # float: the exact rung needs them
    atrace, btrace, _ = tier_traces(seed, cfg.vocab_size)
    out = {"launches": {}, "launches_by_run": {}, "seconds_by_part": {}}
    t_part = time.perf_counter()

    def lap(name):
        nonlocal t_part
        now = time.perf_counter()
        out["seconds_by_part"][name] = now - t_part
        t_part = now

    def counted(path, name, run):
        return count_launches(out, path, name, run)

    numbers = session_numbers

    def oracles(name, tr, res, loop="async"):
        """Each rung's requests of ``tr`` served alone by a single-mode
        session of that rung (uncounted): every token equal to ``res``'s.
        Each request arrives at the tick the tier session admitted it, so
        the oracle admits it in the same prefill batch (rows and bucket):
        on the card the rounding of the exact rung's bf16 GEMMs and of the
        prefill's attention follows their shapes."""
        rows = {}
        for t in LADDER:
            ids = [rid for rid in sorted(res) if res[rid].tier == t]
            if not ids:
                continue
            k1 = approx_matmul.launches
            tcfg = dataclasses.replace(cfg, approx=resolve_execution_mode(
                t, TIER_MULTIPLIER, act_per_row=True))
            sess = share_session(tcfg, params, dev, seed, loop=loop)
            for rid in ids:
                p, n, *_ = tr[rid]
                sess.submit(p, max_new=n, arrival=res[rid].admitted_tick, req_id=rid)
            t0 = time.perf_counter()
            ores = sess.run()
            torch.cuda.synchronize()
            rows[t] = {**numbers(sess, ores, time.perf_counter() - t0), "requests": ids,
                       "k1_launches": approx_matmul.launches - k1}
            if t == "exact" and rows[t]["k1_launches"]:
                raise AssertionError(f"the exact rung's oracle launched K1 {rows[t]}")
            for rid in ids:
                same_tokens(f"{name}, request {rid} at {t} vs its single-mode session",
                            res[rid].tokens.tolist(), ores[rid].tokens.tolist())
        return rows

    # (a) mixed tiers: rungs round-robin, the last request at the best rung
    a = out["mixed"] = {}
    mixed = {}
    for loop in ("async", "sync"):
        sess = share_session(cfg, params, dev, seed, loop=loop, tiers=LADDER,
                             tier_multiplier=TIER_MULTIPLIER)
        per_step = record_steps(sess, lambda s: tuple(s.stats.active_per_tier.values()))
        res, wall = counted("tiers", f"mixed_{loop}", lambda: drive(sess, atrace))
        mixed[loop] = res
        a[loop] = {**numbers(sess, res, wall), "active_per_tier": runs(per_step),
                   "tiers": {rid: r.tier for rid, r in sorted(res.items())}}
    for rid, r in mixed["async"].items():
        same_tokens(f"mixed tiers, request {rid}: sync vs async", mixed["sync"][rid].tokens,
                    r.tokens)
        if r.tier != (atrace[rid][3] or LADDER[0]):
            raise AssertionError(f"request {rid} served at {r.tier}, asked {atrace[rid][3]}")
    a["oracles"] = oracles("mixed tiers", atrace, mixed["async"])
    log(f"[tiers] (a) mixed tiers {','.join(LADDER)} ({smi}): {json.dumps(a)}")
    lap("mixed")

    # (b) the shedder: a burst of requests at the best rung, against its
    # schedule on the CPU at reduced width (shape-only: no eos, no value
    # reaches the schedule)
    rcfg = reduced_config(cfg)
    cpu = torch.device("cpu")
    rsess, rres, _, rlevels = shed_session(rcfg, init_params(rcfg, seed=seed, device=cpu), cpu,
                                           seed, [(p % rcfg.vocab_size, n, t) for p, n, t in btrace])
    ref = shed_schedule(rsess, rres, rlevels)
    sess, res, wall, levels = counted("shed", "burst",
                                      lambda: shed_session(cfg, params, dev, seed, btrace))
    got = shed_schedule(sess, res, levels)
    b = out["shed"] = {**got, **numbers(sess, res, wall), "cpu_reduced": ref}
    log(f"[tiers] (b) shedder ({smi}): {json.dumps(b)}")
    if got != ref or got["shed_level"] != 0 or not got["tier_demotions"]:
        raise AssertionError(f"the shedder's schedule on the card {got} vs the CPU's {ref}")
    b["oracles"] = oracles("shed", btrace, res)
    log(f"[tiers] (b) shedder oracles: {json.dumps(b['oracles'])}")
    lap("shed")

    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


CHUNK_RUNS = {"async": ("async", CHUNK), "sync": ("sync", CHUNK),
              f"chunk_{CHUNK_SMALL}": ("async", CHUNK_SMALL)}


def chunked_phase(full, dev, seed, trace, smi, runs):
    """Phase 12 (c): chunked prefill at full width and the model's depth (its
    near-tie gates were sized there) through K1 and K2 (see the module
    text); ``trace`` is phase 4's.  ``runs``: which of CHUNK_RUNS to serve;
    with "async" also the unchunked session and the gates against it.  The
    sync run is served by another call, and ``chunked_sync_gate`` holds it
    to the async run."""
    from repro_torch.models.transformer import forward, init_params

    t_phase = time.perf_counter()
    vocab = full.vocab_size
    out = {"launches": {}, "launches_by_run": {}, "seconds_by_part": {}, "tokens": {}}

    def counted(path, name, run):
        return count_launches(out, path, name, run)

    numbers = session_numbers
    # phase 4's trace and two prompts past the largest bucket, on phase 4's
    # frozen weights (as phases 4 and 10)
    fparams = init_params(full, seed=seed, device=dev, freeze=True)
    next_budget()                       # the float32 weights are gone
    ctrace = list(trace) + [(p, 16, 2) for p in tier_traces(seed, vocab)[2]]
    ckw = dict(prefill_decode_ratio=1.0, max_len=CHUNK_MAX_LEN)
    c = out["chunked"] = {}
    cres = {}
    for name in runs:
        loop, chunk = CHUNK_RUNS[name]
        sess = share_session(full, fparams, dev, seed, loop=loop, chunked_prefill=True,
                             prefill_chunk=chunk, **ckw)
        res, wall = counted("chunked", name, lambda: drive(sess, ctrace))
        plan = sum(-(-p.size // chunk) for p, _, _ in ctrace if p.size > chunk)
        cres[name] = res
        st = sess.stats
        c[name] = {**numbers(sess, res, wall), "prefill_chunks": st.prefill_chunks,
                   "planned_chunks": plan, "max_decode_gap_ticks": st.max_decode_gap_ticks,
                   "prefills": {str(k): v for k, v in sorted(st.prefills.items())},
                   "ttft_ticks": {rid: r.ttft for rid, r in sorted(res.items())}}
        if st.prefill_chunks != plan:
            raise AssertionError(f"chunked {name}: {st.prefill_chunks} chunk rows, the plan "
                                 f"has {plan}")
        out["tokens"][name] = {rid: r.tokens.tolist() for rid, r in res.items()}
    if "async" not in runs:
        del fparams
        gc.collect()
        torch.cuda.empty_cache()
        out["seconds"] = time.perf_counter() - t_phase
        return out
    sess = share_session(full, fparams, dev, seed, prompt_buckets=WIDE_BUCKETS,
                         **{**ckw, "max_len": WIDE_MAX_LEN})
    ures, wall = drive(sess, ctrace)
    st = sess.stats
    c["unchunked"] = {**numbers(sess, ures, wall), "max_decode_gap_ticks": st.max_decode_gap_ticks,
                      "ttft_ticks": {rid: r.ttft for rid, r in sorted(ures.items())}}
    c["near_ties"] = {}

    def near_tie(name, rid, toks, want):
        """Two arithmetics (the fused prefill, whose rounding follows its
        admission batch, against the per-position chunk pass): the streams
        equal up to their first divergence, and there the two tokens'
        logits in ``forward`` over the common prefix within NEAR_TIE."""
        if toks == want:
            return
        k = next((i for i, (x, y) in enumerate(zip(toks, want)) if x != y), None)
        if k is None:
            raise AssertionError(f"{name}, request {rid}: {len(toks)} vs {len(want)} tokens")
        p = ctrace[rid][0]
        with torch.no_grad():
            lg = forward(full, fparams, torch.as_tensor(
                np.concatenate([p, np.asarray(want[:k], p.dtype)])[None], device=dev))[0, -1]
        top = torch.topk(lg[:vocab], 2)
        row = c["near_ties"][f"{name}/{rid}"] = {
            "new_token_index": k, "tokens": [toks[k], want[k]],
            "logits": [lg[toks[k]].item(), lg[want[k]].item()],
            "top2": {"tokens": top.indices.tolist(), "logits": top.values.tolist()}}
        log(f"[tiers] (c) {name}, request {rid} parts at a near tie: {json.dumps(row)}")
        if abs(row["logits"][0] - row["logits"][1]) > NEAR_TIE:
            raise AssertionError(f"{name}, request {rid}: not a near tie {row}")

    for rid, r in cres["async"].items():
        toks = r.tokens.tolist()
        # gate 2: a prompt both chunk sizes chunk goes through the chunk
        # pass in both, which is chunk-invariant at its fixed width
        small = cres[f"chunk_{CHUNK_SMALL}"][rid].tokens.tolist()
        if ctrace[rid][0].size > CHUNK:
            same_tokens(f"chunked, request {rid}: chunks of {CHUNK_SMALL} vs {CHUNK}", small, toks)
        else:
            near_tie(f"chunks of {CHUNK_SMALL} vs {CHUNK}", rid, small, toks)
        # gate 3: against the fused prefill of the unchunked session
        near_tie("chunked vs unchunked", rid, toks, ures[rid].tokens.tolist())
    short = range(len(trace))                 # all but the two long prompts
    c["short_ttft_p50_ticks"] = {
        name: float(np.median([c[name]["ttft_ticks"][rid] for rid in short]))
        for name in ("async", "unchunked")}
    log(f"[tiers] (c) chunked prefill ({smi}): {json.dumps(c)}")
    del fparams, sess
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def chunked_sync_gate(sync, asyn):
    """Phase 12 (c)'s first gate: the sync loop's chunked run makes the same
    dispatches as the async loop's, so every request's tokens are equal."""
    for rid, toks in asyn.items():
        same_tokens(f"chunked, request {rid}: sync vs async", sync[rid], toks)




# ---------------------------------------------------------------------------
# phase 13: families
# ---------------------------------------------------------------------------


def family_trace(rng, vocab):
    """FAMILY_REQUESTS requests of 8-32 prompt tokens and 8-12 new, two at
    tick 0, then one per tick."""
    return [(rng.integers(0, vocab, int(rng.integers(8, 33))), int(rng.integers(8, 13)),
             max(0, i - 1)) for i in range(FAMILY_REQUESTS)]


def family_session(cfg, params, dev, seed, **kw):
    """Phase 13's session: 4 slots, buckets 16/32, async; moe on the paged
    pool through K2, ssm and hybrid on the slot layout."""
    layout = "paged" if cfg.family == "moe" else "slots"
    kw = {"max_len": FAMILY_MAX_LEN, "prompt_buckets": FAMILY_BUCKETS, "cache_layout": layout,
          "attn_impl": "kernel" if layout == "paged" else "gather", **kw}
    return share_session(cfg, params, dev, seed, **kw)


def rehearse_passes(cfg, trace, seed):
    """The forward and decode passes phase 13's session makes on ``trace``:
    the same session on the CPU at reduced width (a schedule is shape-only:
    no eos), its K1 calls (the plain version's, counted) over one pass's."""
    import repro_torch.core.approx as A
    from repro_torch.configs import reduced_config
    from repro_torch.models.transformer import init_params

    rcfg = dataclasses.replace(reduced_config(cfg), approx=cfg.approx)
    params = init_params(rcfg, seed=seed, device="cpu", freeze=True)
    calls, inner = [0], A.approx_matmul

    def counting(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    A.approx_matmul = counting
    try:
        drive(family_session(rcfg, params, "cpu", seed),
              [(p % rcfg.vocab_size, n, a) for p, n, a in trace])
    finally:
        A.approx_matmul = inner
    per = k1_per_pass(rcfg)
    if calls[0] % per:
        raise AssertionError(f"{cfg.name}: {calls[0]} K1 calls at reduced width are not "
                             f"whole passes of {per}")
    return calls[0] // per


def time_admissions(sess):
    """Each admission's rows, host seconds and CUDA events around its
    launches (read after the run: the async loop never waits on them)."""
    rows, inner = [], sess._admit_many

    def admit(reqs, tier_idx=0):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        inner(reqs, tier_idx)
        rows.append((len(reqs), time.perf_counter() - t0, e0, e1))
        e1.record()

    sess._admit_many = admit
    return rows


def record_drops(admissions):
    """The dropped assignments (past an expert's capacity) of every MoE
    routing, as device counts, and where each admission's routings start
    (``admissions`` is ``time_admissions``' list)."""
    import repro_torch.models.moe as M

    drops, inner = [], M.route

    def route(x, router, top_k, capacity, mesh=None):
        r = inner(x, router, top_k, capacity, mesh=mesh)
        drops.append((len(admissions), x.shape[0], (~r.keep).sum()))
        return r

    M.route = route
    return drops, lambda: setattr(M, "route", inner)


def forward_vs_decode(cfg, params, prompt, dev):
    """Logits of ``forward`` (the chunked scans) and of the prompt
    teacher-forced through ``decode_step``: their largest difference and
    the worst excess over JAX's tolerance (|d| <= 2e-3 + 2e-2 |forward|)."""
    from repro_torch.models.transformer import decode_step, forward, init_cache

    toks = torch.as_tensor(prompt[None], device=dev)
    S0 = toks.shape[1]
    with torch.no_grad():
        ref = forward(cfg, params, toks)[0, :, :cfg.vocab_size].float()
        cache = init_cache(cfg, 1, S0, device=dev)
        got = torch.stack([decode_step(cfg, params, cache, toks[:, i:i + 1],
                                       torch.full((1,), i, device=dev))[0, 0, :cfg.vocab_size]
                           for i in range(S0)]).float()
    d = (got - ref).abs()
    return {"S": S0, "max_abs_diff": d.max().item(), "max_abs_logit": ref.abs().max().item(),
            "excess_over_tol": (d - 2e-3 - 2e-2 * ref.abs()).max().item(),
            "argmax_equal_share": (got.argmax(-1) == ref.argmax(-1)).float().mean().item()}


def family_phase(arch, dev, seed, smi, profile=False):
    """Phase 13 for one of FAMILY_ARCHS (see the module text)."""
    from repro_torch.configs import get_config
    from repro_torch.core.approx import ApproxConfig
    from repro_torch.kernels.approx_matmul import approx_matmul, approx_matmul_plain
    from repro_torch.models.moe import moe_capacity
    from repro_torch.models.transformer import forward, init_params
    from repro_torch.serve import PromptBuckets, freeze_params, generate, resolve_execution_mode

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), approx=resolve_execution_mode(
        "approx", TIER_MULTIPLIER, act_per_row=True))
    rng = np.random.default_rng(seed + 13)
    trace = family_trace(rng, cfg.vocab_size)
    if cfg.family == "moe":
        # the permitted cut (a qwen2-moe-a2.7b pass is over 3 s of host
        # time): 4 requests of 8 new tokens, in (b) and (c) alike
        trace = [(p, MOE_NEW, a) for p, _, a in trace[:MOE_REQUESTS]]
    out = {"arch": arch, "family": cfg.family, "seconds_by_part": {}}
    t_part = time.perf_counter()

    def lap(name):
        nonlocal t_part
        now = time.perf_counter()
        out["seconds_by_part"][name] = now - t_part
        t_part = now

    # (a) K1 at every new (K, N), at M = 4 and at the first admission's M
    d, L = cfg.d_model, cfg.num_layers
    first_bucket = max(PromptBuckets(FAMILY_BUCKETS).bucket(p.size) for p, _, _ in trace[:2])
    if cfg.family == "moe":
        hq = cfg.num_heads * cfg.head_dim
        adm = 2 * first_bucket
        cap = moe_capacity(adm, cfg.moe_top_k, cfg.moe_experts, cfg.capacity_factor)
        kn_m = [((d, hq), adm), ((d, cfg.d_ff), cap), ((cfg.d_ff, d), cap),
                ((d, cfg.moe_shared_ff), adm), ((cfg.moe_shared_ff, d), adm),
                ((d, cfg.padded_vocab), adm)]
    elif cfg.family == "ssm":
        di = cfg.d_inner
        kn_m = [((d, 2 * di), 2), ((di, cfg.dt_rank + 2 * cfg.ssm_state), 2),
                ((cfg.dt_rank, di), 2), ((di, d), 2), ((d, cfg.padded_vocab), 2)]
    else:
        di, N = cfg.d_inner, cfg.ssm_state
        kn_m = [((d, 2 * di + 2 * N + cfg.ssm_heads), 2), ((di, d), 2),
                ((d, cfg.num_heads * cfg.head_dim), 2), ((d, cfg.d_ff), 2), ((cfg.d_ff, d), 2),
                ((d, cfg.padded_vocab), 2)]
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    k1 = []
    for (K, N), m_adm in kn_m:
        for M in sorted({NUM_SLOTS, m_adm}):
            a = torch.randint(0, 256, (M, K), generator=gen, device=dev, dtype=torch.uint8)
            b = torch.randint(0, 256, (K, N), generator=gen, device=dev, dtype=torch.uint8)
            got = approx_matmul(a, b, multiplier=TIER_MULTIPLIER)
            want = approx_matmul_plain(a, b, multiplier=TIER_MULTIPLIER)
            if got.dtype != torch.int32 or not torch.equal(got, want):
                raise AssertionError(f"[families] {arch}: K1 at M={M} K={K} N={N} differs "
                                     "from its plain version")
            k1.append([M, K, N])
    out["k1_equal_shapes"] = k1
    log(f"[families] {arch} (a) K1 bit-equal at (M, K, N) {k1}")
    lap("a")            # (a)'s K2 at the moe shape: ``family_k2``, in the parent process
    if cfg.family == "moe":
        # phase 18 runs in this unit, on (c)'s weights and tp=1 run: its
        # (a) here, its tp=2 and tp=4 worlds after (c)
        ep = {"runs": {}, "launches": {}}
        ep["k1_equal_shapes"], ep["k2"] = ep_kernel_checks(
            cfg, dev, torch.Generator(device=dev).manual_seed(seed + 18),
            np.random.default_rng(seed + 18), adm)
        ep_tmp = tempfile.TemporaryDirectory(prefix="ep_")
        lap("ep_a")

    # (b) full depth: the trace on the async loop through K1 (and K2)
    passes = rehearse_passes(cfg, trace, seed)
    predicted = passes * k1_per_pass(cfg)
    lap("rehearsal")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=dev, freeze=True)
    torch.cuda.synchronize()
    out["init_freeze_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    sess = family_session(cfg, params, dev, seed)
    adm = time_admissions(sess)
    res, one = counted_run(sess, trace, adm)
    wall, n, drops = one["wall_s"], one["launches"], one["drops"]
    b = {**session_numbers(sess, res, wall), "launches": n, "passes": passes,
         "k1_per_pass": k1_per_pass(cfg), "k1_predicted": predicted,
         "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
         "admissions": [{"rows": r, "host_s": h, "event_s": e0.elapsed_time(e1) / 1e3}
                        for r, h, e0, e1 in adm]}
    if cfg.family == "moe":
        per_adm = {}
        for i, T, nd in drops:
            if T > NUM_SLOTS:                   # an admission's routings (decode: 4 rows)
                per_adm[i] = per_adm.get(i, 0) + int(nd)
        b["dropped_assignments_per_admission"] = [per_adm.get(i, 0) for i in range(len(adm))]
        b["decode_drops"] = sum(int(nd) for _, T, nd in drops if T <= NUM_SLOTS)
    out["serve"] = b
    log(f"[families] {arch} (b) full depth ({smi}): {json.dumps(b)}")
    for rid, r in res.items():
        if r.tokens.shape != (trace[rid][1],) or not (
                (r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all():
            raise AssertionError(f"[families] {arch}, request {rid}: bad tokens "
                                 f"{r.tokens.tolist()}")
    if n["approx_matmul"] != predicted:
        raise AssertionError(f"[families] {arch}: K1 launched {n['approx_matmul']} times, "
                             f"predicted {predicted} ({passes} passes x {k1_per_pass(cfg)})")
    if (n["paged_attention"] > 0) != (cfg.family == "moe"):
        raise AssertionError(f"[families] {arch}: K2 launched {n['paged_attention']} times")
    out["launches"] = n
    prompt32 = rng.integers(0, cfg.vocab_size, 32)
    if cfg.family != "moe":
        # the scans against the teacher-forced decode at full depth, bf16
        # activations through K1: printed, not gated
        out["forward_vs_decode_full"] = forward_vs_decode(cfg, params, prompt32, dev)
        log(f"[families] {arch} (b) forward vs decode, full depth, bf16 approx: "
            f"{json.dumps(out['forward_vs_decode_full'])}")
    if profile:
        out["profile"] = profile_decode(cfg, params, trace, dev, seed, ticks=3, loop="async",
                                        cache_layout="paged" if cfg.family == "moe" else "slots")
        log(f"[families] {arch} (b) profiled tick: {json.dumps(out['profile'])}")
    lap("b")
    del params, sess
    gc.collect()
    torch.cuda.empty_cache()

    # (c) oracles at ORACLE_LAYERS of the full width (the hybrid: one
    # group of its attn_every layers and the shared block)
    depth = cfg.attn_every if cfg.family == "hybrid" else ORACLE_LAYERS
    cfg4 = dataclasses.replace(cfg, num_layers=depth)
    fparams = init_params(cfg4, seed=seed + 1, device=dev)
    params4 = freeze_params(cfg4, fparams)
    c = {"layers": depth}
    runs_ = {}
    for name, ccfg, loop in (("k1_async", cfg4, "async"), ("k1_sync", cfg4, "sync"),
                             ("plain_async", dataclasses.replace(cfg4, approx=resolve_execution_mode(
                                 "approx_lowrank", TIER_MULTIPLIER, act_per_row=True)), "async")):
        runs_[name], numbers = counted_run(family_session(ccfg, params4, dev, seed, loop=loop),
                                           trace)
        if name == "k1_async":
            one4 = numbers                      # phase 18's tp=1 run at 4 layers
    for rid in range(len(trace)):
        want = runs_["k1_async"][rid].tokens
        same_tokens(f"[families] {arch} 4-layer request {rid}: plain K1 vs K1",
                    runs_["plain_async"][rid].tokens, want)
        same_tokens(f"[families] {arch} 4-layer request {rid}: sync vs async",
                    runs_["k1_sync"][rid].tokens, want)
    c["k1_vs_plain"] = c["sync_vs_async"] = "equal"
    if cfg.family == "moe":
        toks = np.zeros((2, BUCKETS[-1]), np.int32)
        for i in (0, 1):
            toks[i, :trace[i][0].size] = trace[i][0]
        c["k2_vs_gather_step"] = decode_step_diff(cfg4, params4, trace,
                                                  torch.as_tensor(toks, device=dev), dev,
                                                  near_tie=NEAR_TIE)
    else:
        fcfg = dataclasses.replace(cfg4, dtype="float32", approx=ApproxConfig(mode="float"),
                                   ssm_chunk=256)
        fd = c["forward_vs_decode"] = forward_vs_decode(fcfg, fparams, prompt32, dev)
        if fd["excess_over_tol"] > 0:
            raise AssertionError(f"[families] {arch}: forward and decode part beyond JAX's "
                                 f"tolerance: {fd}")
        c["vs_generate"], c["near_ties"] = {}, {}
        for rid, (p, n_new, _) in enumerate(trace):
            got = runs_["k1_async"][rid].tokens.tolist()
            alone = generate(cfg4, params4, p[None], max_new=n_new, prefill_mode="decode",
                             device=dev)[0, p.size:].tolist()
            if got == alone:
                c["vs_generate"][rid] = "equal"
                continue
            k = next(i for i, (x, y) in enumerate(zip(got, alone)) if x != y)
            with torch.no_grad():
                lg = forward(cfg4, params4, torch.as_tensor(
                    np.concatenate([p, np.asarray(alone[:k], p.dtype)])[None], device=dev))[0, -1]
            tie = c["near_ties"][rid] = {"new_token_index": k, "tokens": [got[k], alone[k]],
                                         "logits": [lg[got[k]].item(), lg[alone[k]].item()]}
            c["vs_generate"][rid] = "near tie"
            if abs(tie["logits"][0] - tie["logits"][1]) > NEAR_TIE:
                raise AssertionError(f"[families] {arch}, request {rid}: the session and "
                                     f"generate alone part, not at a near tie: {tie}")
    out["oracle"] = c
    log(f"[families] {arch} (c) {depth} layers: {json.dumps(c)}")
    lap("c")
    if cfg.family == "moe":                     # phase 18's weights, written in a thread
        saved4 = ep_save(params4, ep_tmp.name, "frozen4.pt")
    del fparams, params4
    gc.collect()
    torch.cuda.empty_cache()
    if cfg.family == "moe":                     # phase 18 (b)-(d): tp=2 and tp=4 at 4 layers
        for tp in EP_DEGREES:
            row, ep["launches"][f"ep{tp}_kernel"] = ep_world(cfg4, tp, saved4, one4, trace,
                                                             dev, seed)
            ep["runs"][f"tp={tp} {cfg4.num_layers} layers"] = row
            lap(f"ep_tp{tp}")
        ep_tmp.cleanup()
        ep["seconds_by_part"] = {k: v for k, v in out["seconds_by_part"].items()
                                 if k.startswith("ep_")}
        ep["seconds"] = sum(ep["seconds_by_part"].values())
        ep["unit_peak_reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
        log(f"[ep] phase 18 took {ep['seconds']:.1f}s in the {arch} unit (gloo on one card, "
            f"{smi})")
        out["ep"] = ep
    out["seconds"] = time.perf_counter() - t_phase
    return out


def family_k2(cfg, dev, seed):
    """K2 at the moe model's shape (B 4, H 16, Hkv 16, hd 128, 16-row
    blocks): phase 3's cases on both pool dtypes, then one served decode
    step's calls timed beside the bound and SDPA."""
    rng = np.random.default_rng(seed + 130)
    hkv, g, hd = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.head_dim
    W = FAMILY_MAX_LEN // BLOCK_SIZE
    worst = [0.0, 0.0]
    for pool, pool_dtype in K2_POOLS.items():
        case = lambda **kw: paged_case(rng, dev, NUM_SLOTS, W, BLOCK_SIZE, hkv, g, hd,
                                       pool_dtype=pool_dtype, **kw)
        cases = [(f"holes={h}", case(holes=h)) for h in (False, True)]
        args = case()
        nb = args[3].shape[0]
        args[5] = torch.as_tensor(rng.permutation(nb)[:NUM_SLOTS * W].reshape(NUM_SLOTS, W),
                                  dtype=torch.int32, device=dev)
        args[6] = torch.as_tensor(BLOCK_SIZE * rng.integers(0, W, NUM_SLOTS), dtype=torch.int32,
                                  device=dev)
        cases.append(("cur_len on a block boundary", args))
        for name, args in cases:
            errs = k2_check(f"moe {pool} {name}", args, BLOCK_SIZE)
            worst = [max(x, y) for x, y in zip(worst, errs)]
    cur = rng.integers(FAMILY_MAX_LEN // 4, FAMILY_MAX_LEN, NUM_SLOTS)
    step = {pool: k2_timed(dev, rng, calls=cfg.num_layers, B=NUM_SLOTS, W=W, hkv=hkv, g=g,
                           hd=hd, cur=cur, pool_dtype=dt) for pool, dt in K2_POOLS.items()}
    for row in step.values():
        worst = [max(worst[0], row["max_abs_err_f32_q"]), max(worst[1], row["max_abs_err_bf16_q"])]
    log(f"[families] K2 at H {cfg.num_heads}, Hkv {hkv}, hd {hd}: max abs err {worst}; "
        f"decode step {json.dumps(step)}")
    return {"max_abs_err": worst[0], "max_abs_err_bf16_q": worst[1], "decode_step": step}


# ---------------------------------------------------------------------------
# phase 14: training of the moe, ssm and hybrid families
# ---------------------------------------------------------------------------


def state_digest(tree, chunk=1 << 24):
    """Per leaf of a training state, exact integer sums over its 32-bit
    words: of their low and high 16 bits, plain and each times two fixed
    pseudo-random weights per position (drawn from a seed per chunk).  Two
    states bit-identical give equal digests; one word that differs changes
    them with certainty, and the weighted sums catch words that differ in
    pairs.  Nothing here holds a second copy of a state (a 4-layer
    qwen2-moe-a2.7b state is 35 GB)."""
    from repro_torch.train.tree import leaves

    out = []
    for leaf in leaves(tree):
        words = leaf.detach().reshape(-1).view(torch.int32)
        sums = [0] * 6
        gen = torch.Generator(device=words.device)
        for i in range(0, words.numel(), chunk):
            c = words[i:i + chunk].to(torch.int64)
            lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
            gen.manual_seed(i)
            r = torch.randint(1, 1 << 16, (2,) + c.shape, generator=gen, device=c.device)
            parts = torch.stack([lo.sum(), hi.sum(), (lo * r[0]).sum(), (hi * r[0]).sum(),
                                 (lo * r[1]).sum(), (hi * r[1]).sum()])
            sums = [a + b for a, b in zip(sums, parts.tolist())]
        out.append(tuple(sums))
    return out


def one_step(cfg, opt, seed, batch, dev):
    """A fresh ``init_state(cfg, seed)`` stepped once on ``batch``: (loss,
    grad norm, the new state's digest, K1 launches)."""
    from repro_torch.kernels.approx_matmul import approx_matmul
    from repro_torch.train.loop import init_state, make_train_step

    state = init_state(cfg, opt, seed, device=dev)
    n0 = approx_matmul.launches
    state, m = make_train_step(cfg, opt)(state, batch)
    torch.cuda.synchronize()
    n = approx_matmul.launches - n0
    out = (m["loss"].item(), m["grad_norm"].item(), state_digest(state), n)
    del state, m
    gc.collect()                # the next run reuses the allocator's cached blocks
    return out


def train_oracle(cfg, opt, seed, batch, dev, name):
    """The 4-layer oracle (the hybrid: one group of ``attn_every``; a model
    trained shallower: its depth): one step through K1, the same step
    through K1 again and through its plain version (``lowrank``), each
    from the same fresh state on the same batch; their losses and whole
    new states must be bit-identical."""
    depth = cfg.attn_every if cfg.family == "hybrid" else min(ORACLE_LAYERS, cfg.num_layers)
    cfg4 = dataclasses.replace(cfg, num_layers=depth)
    plain = dataclasses.replace(cfg4, approx=dataclasses.replace(cfg4.approx, mode="lowrank"))
    runs = {k: one_step(c, opt, seed + 1, batch, dev)
            for k, c in (("kernel", cfg4), ("kernel_again", cfg4), ("plain", plain))}
    res = {"layers": depth, **{f"loss_{k}": r[0] for k, r in runs.items()},
           "k1_launches": {k: r[3] for k, r in runs.items()},
           "k1_predicted": k1_per_train_step(cfg4),
           "leaves": len(runs["kernel"][2]),
           "kernel_again_identical": runs["kernel_again"][:3] == runs["kernel"][:3],
           "plain_identical": runs["plain"][:3] == runs["kernel"][:3]}
    log(f"[{name}] oracle: {json.dumps(res)}")
    if not (res["kernel_again_identical"] and res["plain_identical"]):
        raise AssertionError(f"[{name}] a {depth}-layer training step through K1 is not "
                             f"bit-identical to {'its plain version' if res['kernel_again_identical'] else 'itself'}: {res}")
    if res["k1_launches"] != {"kernel": res["k1_predicted"], "kernel_again": res["k1_predicted"],
                              "plain": 0}:
        raise AssertionError(f"[{name}] oracle launches {res['k1_launches']}, predicted "
                             f"{res['k1_predicted']} per K1 step and none for the plain one")
    return res


def train_config(arch, depth):
    """``arch`` at its registered widths and ``depth`` layers, trained as
    ``launch/train.py`` trains: mul8x8_2 through K1, band_reg 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.core.approx import ApproxConfig

    return dataclasses.replace(get_config(arch), num_layers=depth, approx=ApproxConfig(
        multiplier=TIER_MULTIPLIER, mode="kernel", band_reg=1e-4))


def train_family_phase(arch, dev, seed):
    """Phase 14 for one of FAMILY_ARCHS (see the module text)."""
    from repro_torch.data.synthetic import token_batches
    from repro_torch.launch import train as launch_train
    from repro_torch.train import optim as O
    from repro_torch.train.loop import as_batch

    t_phase = time.perf_counter()
    name = f"train {arch}"
    seconds = {}
    t_part = t_phase

    def lap(part):
        nonlocal t_part
        now = time.perf_counter()
        seconds[part] = now - t_part
        t_part = now

    cfg = train_config(arch, TRAIN_DEPTHS[arch])
    opt = O.OptConfig(lr=3e-4, total_steps=TRAIN_STEPS_FAMILY)        # as launch/train.py
    steps, dp_row, dp_launches = train_dp_world(cfg, opt, seed, dev, name)
    out = {"arch": arch, "family": cfg.family, "seconds_by_part": seconds, **steps,
           "dp": dp_row, "dp_launches": dp_launches}
    lap("steps")
    batch = as_batch(next(token_batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                                        seed=seed + 1)), dev)
    out["oracle"] = train_oracle(cfg, opt, seed, batch, dev, name)
    lap("oracle")

    # the launcher at reduced size, then resumed from its checkpoint
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt-")
    try:
        common = ["--arch", arch, "--reduced", "--ckpt", tmp, "--ckpt-every", "2",
                  "--seed", str(seed)]
        first = launch_train.main(common + ["--steps", "2"])
        second = launch_train.main(common + ["--steps", "4"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launcher"] = {"first_losses": first["losses"], "resumed_at": second["start"],
                       "second_losses": second["losses"]}
    log(f"[{name}] launcher: {json.dumps(out['launcher'])}")
    if first["start"] != 0 or second["start"] != 2 or len(second["losses"]) != 2 or not all(
            math.isfinite(x) for x in first["losses"] + second["losses"]):
        raise AssertionError(f"[{name}] the launcher did not resume from its checkpoint: "
                             f"{out['launcher']}")
    lap("launcher")
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 15: the vlm and audio backbones
# ---------------------------------------------------------------------------


def thw_grid(B, S, prefix):
    """Multimodal rope positions (B, 3, S): ``prefix`` text tokens, then an
    image of 4 x 4 patches (t held, h and w over the grid), then text from
    the next free position: three streams that differ."""
    thw = torch.empty((3, S), dtype=torch.long)
    thw[:, :prefix] = torch.arange(prefix)
    h, w = torch.arange(16) // 4, torch.arange(16) % 4
    img = slice(prefix, prefix + 16)
    thw[0, img], thw[1, img], thw[2, img] = prefix, prefix + h, prefix + w
    thw[:, prefix + 16:] = prefix + 4 + torch.arange(S - prefix - 16)
    return thw[None].expand(B, 3, S).clone()


def embedding_batch(cfg, B, S, gen, dev):
    """Seeded embeddings (B, S, d) on the card, and for the vlm a
    ``positions_thw`` grid (an image after an 8-token prefix)."""
    emb = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
    thw = thw_grid(B, S, 8).to(dev) if cfg.pos_embedding == "m_rope" else None
    return emb, thw


def logits_agree(got, ref, near_tie):
    """Per position, ``got`` within JAX's forward-vs-decode tolerance of
    ``ref`` (|d| <= 2e-3 + 2e-2 |ref|), or, where not, the same argmax or a
    near tie: ``got``'s argmax within ``near_tie`` of ``ref``'s top logit
    in ``ref``.  Returns the numbers and the positions beyond both."""
    d = (got - ref).abs()
    beyond = (d > 2e-3 + 2e-2 * ref.abs()).any(-1)
    a, b = got.argmax(-1), ref.argmax(-1)
    gap = ref.max(-1).values - ref.gather(-1, a[..., None])[..., 0]
    bad = beyond & (a != b) & (gap > near_tie)
    return {"max_abs_diff": d.max().item(), "max_abs_logit": ref.abs().max().item(),
            "beyond_tol_positions": int(beyond.sum()), "argmax_equal_share":
            (a == b).float().mean().item(), "worst_near_tie_gap": gap.max().item()}, bad


class K2Check:
    """Wraps ``models.attention.paged_attention`` for a run: each call
    launches K2 and is held against its plain version on the same inputs
    (within K2_TOL plus the bf16 rounding of |ref| for a bf16 query, as
    phase 3 holds it); the plain calls do not count as launches."""

    def __init__(self):
        import repro_torch.models.attention as A
        from repro_torch.kernels.paged_attention import paged_attention_plain

        self.mod, self.inner, self.plain = A, A.paged_attention, paged_attention_plain
        self.calls, self.err = 0, 0.0

    def __call__(self, q, *rest, block_size):
        out = self.inner(q, *rest, block_size=block_size)
        ref = self.plain(q, *rest, block_size=block_size)
        dev_ = (out.float() - ref).abs()
        slack = ref.abs() * 2.0 ** -8 if q.dtype == torch.bfloat16 else 0.0
        if not bool((dev_ <= K2_TOL + slack).all()):
            raise AssertionError(f"K2 call {self.calls}: max abs err {dev_.max().item()} "
                                 "beyond its plain version's tolerance")
        self.calls += 1
        self.err = max(self.err, dev_.max().item())
        return out

    def __enter__(self):
        self.mod.paged_attention = self
        return self

    def __exit__(self, *exc):
        self.mod.paged_attention = self.inner


def backbone_phase(arch, dev, seed):
    """Phase 15 for one of BACKBONE_ARCHS (see the module text)."""
    from repro_torch.configs import get_config
    from repro_torch.core.approx import ApproxConfig
    from repro_torch.kernels.approx_matmul import approx_matmul, approx_matmul_plain
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.models.transformer import (decode_step, forward, init_cache,
                                                init_paged_cache, init_params,
                                                paged_decode_step)
    from repro_torch.serve import resolve_execution_mode
    from repro_torch.train import optim as O

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), approx=resolve_execution_mode(
        "approx", TIER_MULTIPLIER, act_per_row=True))
    out = {"arch": arch, "family": cfg.family, "k1_per_pass": k1_per_pass(cfg),
           "seconds_by_part": {}}
    t_part = time.perf_counter()

    def lap(part):
        nonlocal t_part
        now = time.perf_counter()
        out["seconds_by_part"][part] = now - t_part
        t_part = now

    # K2 at this model's shape, as phase 3 holds it: f32 and bf16 queries,
    # both pool dtypes, with and without sentinel holes
    rng = np.random.default_rng(seed + 150)
    hkv, g, hd = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.head_dim
    worst = [0.0, 0.0]
    for pool, pool_dtype in K2_POOLS.items():
        for holes in (False, True):
            args = paged_case(rng, dev, NUM_SLOTS, FAMILY_MAX_LEN // BLOCK_SIZE, BLOCK_SIZE,
                              hkv, g, hd, holes=holes, pool_dtype=pool_dtype)
            errs = k2_check(f"{arch} {pool} holes={holes}", args, BLOCK_SIZE)
            worst = [max(x, y) for x, y in zip(worst, errs)]
    out["k2_check"] = {"H": cfg.num_heads, "Hkv": hkv, "hd": hd, "max_abs_err": worst[0],
                       "max_abs_err_bf16_q": worst[1]}
    log(f"[{arch}] K2 at H {cfg.num_heads}, Hkv {hkv}, hd {hd}: max abs err {worst}")
    lap("k2")

    # K1 at every (K, N) of this model's projections, at the M of a decode
    # step (B), of a slot pool and of a forward pass (B * S)
    B, S = 2, BACKBONE_SEQ
    d, hq, hkv_w = cfg.d_model, cfg.num_heads * cfg.head_dim, hkv * cfg.head_dim
    kn = sorted({(d, hq), (d, hkv_w), (hq, d), (d, cfg.d_ff), (cfg.d_ff, d),
                 (d, cfg.padded_vocab)})
    gen = torch.Generator(device=dev).manual_seed(seed + 151)
    k1 = []
    for K, N in kn:
        for M in sorted({B, NUM_SLOTS, B * S}):
            a = torch.randint(0, 256, (M, K), generator=gen, device=dev, dtype=torch.uint8)
            b = torch.randint(0, 256, (K, N), generator=gen, device=dev, dtype=torch.uint8)
            got = approx_matmul(a, b, multiplier=TIER_MULTIPLIER)
            want = approx_matmul_plain(a, b, multiplier=TIER_MULTIPLIER)
            if got.dtype != torch.int32 or not torch.equal(got, want):
                raise AssertionError(f"[{arch}] K1 at M={M} K={K} N={N} differs from its "
                                     "plain version")
            k1.append([M, K, N])
    out["k1_equal_shapes"] = k1
    log(f"[{arch}] K1 bit-equal at (M, K, N) {k1}")
    lap("k1")

    gen = torch.Generator(device=dev).manual_seed(seed + 15)
    emb, thw = embedding_batch(cfg, B, S, gen, dev)
    # (a) forward at full depth
    params = init_params(cfg, seed=seed, device=dev, freeze=True)
    with torch.no_grad():
        approx_matmul.launches = paged_attention.launches = 0
        logits = forward(cfg, params, embeddings=emb, positions_thw=thw)
        torch.cuda.synchronize()
        a = {"k1_launches": approx_matmul.launches, "shape": list(logits.shape),
             "finite": bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())}
        ref = forward(cfg, params, embeddings=emb)[..., :cfg.vocab_size].float()
        if thw is not None:
            a["max_abs_diff_vs_default_positions"] = (
                logits[..., :cfg.vocab_size] - ref).abs().max().item()
    out["forward"] = a
    log(f"[{arch}] (a) forward: {json.dumps(a)}")
    if not a["finite"] or a["k1_launches"] != k1_per_pass(cfg):
        raise AssertionError(f"[{arch}] forward: {a}, {k1_per_pass(cfg)} K1 launches "
                             "predicted")
    if thw is not None and not a["max_abs_diff_vs_default_positions"] > 0:
        raise AssertionError(f"[{arch}] the positions grid changes nothing")
    lap("a")

    # (c) teacher-forced decode on the slot layout (gather), then (d) paged
    # through K2, each step held to the slot step
    W = S // BLOCK_SIZE
    with torch.no_grad():
        cache = init_cache(cfg, B, S, device=dev)
        pool = init_paged_cache(cfg, B * W, BLOCK_SIZE, device=dev)
        tables = torch.arange(B * W, dtype=torch.int32, device=dev).reshape(B, W)
        slot, paged, k1 = [], [], []
        with K2Check() as chk:
            for i in range(S):
                cur = torch.full((B,), i, device=dev)
                n0 = approx_matmul.launches
                slot.append(decode_step(cfg, params, cache, None, cur,
                                        embeddings=emb[:, i:i + 1])[:, 0, :cfg.vocab_size])
                k1.append(approx_matmul.launches - n0)
                paged.append(paged_decode_step(cfg, params, pool, None, cur, tables,
                                               block_size=BLOCK_SIZE, attn_impl="kernel",
                                               embeddings=emb[:, i:i + 1])
                             [:, 0, :cfg.vocab_size])
        torch.cuda.synchronize()
    slot, paged = torch.stack(slot, 1).float(), torch.stack(paged, 1).float()
    c, c_bad = logits_agree(slot, ref, NEAR_TIE)
    dpg, d_bad = logits_agree(paged, slot, NEAR_TIE)
    out["launches"] = {"approx_matmul": approx_matmul.launches,
                       "paged_attention": paged_attention.launches}
    out["decode"] = {"steps": S, "k1_per_step": sorted(set(k1)), "vs_forward": c,
                     "k2_calls": chk.calls, "k2_max_abs_err": chk.err, "paged_vs_slot": dpg}
    log(f"[{arch}] (c)-(d) decode: {json.dumps(out['decode'])}; launches "
        f"{json.dumps(out['launches'])}")
    if c_bad.any():
        raise AssertionError(f"[{arch}] teacher-forced decode parts from forward beyond "
                             f"tolerance and near ties at {c_bad.nonzero().tolist()}: {c}")
    if d_bad.any():
        raise AssertionError(f"[{arch}] paged decode through K2 parts from the slot step "
                             f"at {d_bad.nonzero().tolist()}: {dpg}")
    if k1 != [k1_per_pass(cfg)] * S or chk.calls != S * cfg.num_layers \
            or out["launches"] != {"approx_matmul": (2 + 2 * S) * k1_per_pass(cfg),
                                   "paged_attention": chk.calls}:
        raise AssertionError(f"[{arch}] decode launches: K1 {sorted(set(k1))} per slot "
                             f"step, K2 {chk.calls} calls ({out['launches']})")
    del params, cache, pool
    gc.collect()
    torch.cuda.empty_cache()
    lap("c-d")

    # the same, 4 layers deep in float32 and float: within JAX's tolerance
    fcfg = dataclasses.replace(get_config(arch), num_layers=ORACLE_LAYERS, dtype="float32")
    fparams = init_params(fcfg, seed=seed + 1, device=dev)
    with torch.no_grad():
        fref = forward(fcfg, fparams, embeddings=emb)[..., :cfg.vocab_size]
        cache = init_cache(fcfg, B, S, device=dev)
        fdec = torch.stack([decode_step(fcfg, fparams, cache, None,
                                        torch.full((B,), i, device=dev),
                                        embeddings=emb[:, i:i + 1])[:, 0, :cfg.vocab_size]
                            for i in range(S)], 1)
    fd, f_bad = logits_agree(fdec, fref, 0.0)
    out["decode"]["vs_forward_4_layers_f32"] = fd
    log(f"[{arch}] 4 layers, float32: decode vs forward {json.dumps(fd)}")
    if fd["beyond_tol_positions"]:
        raise AssertionError(f"[{arch}] 4-layer float32 decode parts from forward beyond "
                             f"JAX's tolerance: {fd}")
    del fparams, cache
    gc.collect()
    torch.cuda.empty_cache()
    lap("f32")

    # (b) training on embeddings through K1, then the 4-layer oracle
    tcfg = train_config(arch, TRAIN_DEPTHS[arch])
    opt = O.OptConfig(lr=3e-4, total_steps=TRAIN_STEPS_FAMILY)
    steps, dp_row, dp_launches = train_dp_world(tcfg, opt, seed, dev, f"train {arch}")
    out["train"] = {**steps, "dp": dp_row, "dp_launches": dp_launches}
    out["train"]["oracle"] = train_oracle(tcfg, opt, seed, family_batches(tcfg, seed + 1, dev)[0],
                                          dev, f"train {arch}")
    lap("b")
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 16: roofline
# ---------------------------------------------------------------------------


def roofline_step(name, fn, costs, meta_args, args, model_flops, *, grad=False):
    """Phase 16: ``fn`` as counted (``costs``, from 1 and 2 layers by
    ``launch/dryrun.in_depth``; ``meta_args`` its arguments at full depth
    on meta), then run on the card (``args``) with the launch counters
    zeroed just before: its launches equal the counted calls, the counted
    argument bytes equal the real tensors', its bound is at most 1.05x the
    profiler's device time, and the counted temporaries are within
    TEMP_TOL of those ``max_memory_allocated`` shows.  Returns the step's
    numbers."""
    from repro_torch.kernels.approx_matmul import approx_matmul
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.launch.roofline import card_rates, roofline_terms
    from repro_torch.parallel.sharding import tree_bytes

    terms = roofline_terms(flops_per_device=costs.compute_by_class(),
                           bytes_per_device=costs.total_bytes(), wire_bytes_per_device=0.0,
                           n_devices=1, model_flops_global=model_flops)
    counted = {k: costs.kernels.get(k, {}).get("calls", 0)
               for k in ("approx_matmul", "paged_attention")}
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    approx_matmul.launches = paged_attention.launches = 0
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    with torch.set_grad_enabled(grad):
        out = fn(*args)
    e1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    launches = {"approx_matmul": approx_matmul.launches,
                "paged_attention": paged_attention.launches}
    peak = torch.cuda.max_memory_allocated()
    del out

    def again():
        with torch.set_grad_enabled(grad):
            fn(*args)
    prof = profile_step(again)
    device_ms = prof.get("device_ms")
    bound_ms = terms["t_bound_s"] * 1e3
    bf16 = card_rates().bfloat16
    row = {"step": name, "launches": launches, "counted_calls": counted,
           "argument_bytes": tree_bytes(*args), "counted_argument_bytes": tree_bytes(*meta_args),
           "device_ms": device_ms, "events_ms": e0.elapsed_time(e1), "host_ms": host_ms,
           "k1_device_ms": prof.get("k1_device_ms"),
           "bound_ms": bound_ms, "bound_by": terms["bound"],
           "t_compute_ms": terms["t_compute_s"] * 1e3, "t_memory_ms": terms["t_memory_s"] * 1e3,
           "flops_by_class": terms.get("flops_by_class"), "bytes": costs.total_bytes(),
           "kernels": costs.kernels, "model_flops": model_flops,
           "model_flop_share": (model_flops / (device_ms / 1e3) / bf16) if device_ms else None,
           "bound_share": (bound_ms / device_ms) if device_ms else None,
           "predicted_peak_gb": (base + costs.peak_bytes) / 1e9,
           "predicted_temp_gb": costs.peak_bytes / 1e9,
           "max_memory_allocated_gb": peak / 1e9, "measured_temp_gb": (peak - base) / 1e9}
    log(f"[roofline] granite-3-2b {name}: {json.dumps(row)}")
    row["profile"] = prof
    if launches != counted:
        raise AssertionError(f"{name}: launches {launches} != counted calls {counted}")
    if row["argument_bytes"] != row["counted_argument_bytes"]:
        raise AssertionError(f"{name}: arguments {row['argument_bytes']} B, counted "
                             f"{row['counted_argument_bytes']} B")
    if device_ms is None or not bound_ms <= 1.05 * device_ms:
        raise AssertionError(f"{name}: bound {bound_ms} ms above 1.05x the device time "
                             f"{device_ms} ms ({prof.get('note', '')})")
    rel, slack = TEMP_TOL
    if not abs(costs.peak_bytes - (peak - base)) <= rel * (peak - base) + slack:
        raise AssertionError(f"{name}: temporaries counted {costs.peak_bytes} B, measured "
                             f"{peak - base} B, beyond {rel:.0%} + {slack} B")
    return row


def zeros_on(tree, device):
    """A zero-filled twin of a meta tree (a frozen weight's fields too)."""
    from repro_torch.train.tree import tree_map

    z = lambda t: None if t is None else torch.zeros(t.shape, dtype=t.dtype, device=device)
    return tree_map(lambda x: type(x)(*map(z, x)) if isinstance(x, tuple) else z(x), tree)


def roofline_serve(cfg, params, trace, dev):
    """Phase 16's serving steps on phase 4's frozen weights: one fused
    admission prefill of the trace's first two prompts at bucket 128 into
    an f32 paged pool (4 rows of MAX_LEN // BLOCK_SIZE blocks each), then
    one paged decode step of 4 rows through K1 and K2 over it."""
    from repro_torch.launch.dryrun import in_depth
    from repro_torch.launch.roofline import count_costs
    from repro_torch.launch.specs import params_specs
    from repro_torch.models.transformer import forward, init_paged_cache, paged_decode_step
    from repro_torch.serve.cache import scatter_prompt_blocks

    W, nbk, bucket = MAX_LEN // BLOCK_SIZE, BUCKETS[-1] // BLOCK_SIZE, BUCKETS[-1]

    def steps(c, device, p):
        """{name: (step, its arguments)} of config ``c`` on ``device``."""
        def prefill(p, cache, prompts, lens, seat):
            logits, kvs = forward(c, p, prompts, return_kv=True)
            scatter_prompt_blocks(cache, kvs, seat, BLOCK_SIZE)
            return logits[torch.arange(prompts.shape[0], device=prompts.device), lens - 1]

        def decode(p, cache, tokens, cur_len, tables):
            return paged_decode_step(c, p, cache, tokens, cur_len, tables,
                                     block_size=BLOCK_SIZE, attn_impl="kernel")

        i32 = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=device)
        prompts = np.zeros((2, bucket), np.int32)
        for i in (0, 1):
            prompts[i, :trace[i][0].size] = trace[i][0]
        lens = [trace[i][0].size for i in range(NUM_SLOTS)]
        tables = np.arange(NUM_SLOTS * W, dtype=np.int32).reshape(NUM_SLOTS, W)
        cache = init_paged_cache(c, NUM_SLOTS * W, BLOCK_SIZE, device=device)
        return {"prefill": (prefill, (p, cache, i32(prompts), i32(lens[:2]),
                                      i32(tables[:2, :nbk]))),
                "decode": (decode, (p, cache, i32(np.asarray(trace[4][0][:NUM_SLOTS])[:, None]),
                                    i32(lens), i32(tables)))}

    def counted(name):
        # K2's work depends on the table and lengths, which meta tensors do
        # not hold: the decode step is counted on the CPU (zero weights)
        device = "cpu" if name == "decode" else "meta"

        def count(c):
            fn, args = steps(c, device, zeros_on(params_specs(c, frozen=True), device))[name]
            return count_costs(fn, *args)
        # the prefill holds every layer's K/V until it scatters them
        return in_depth(cfg, count, peak="grows" if name == "prefill" else "flat")["total"]

    n_params = cfg.param_count()
    tokens = {"prefill": 2 * bucket, "decode": NUM_SLOTS}
    meta, real = steps(cfg, "meta", params_specs(cfg, frozen=True)), steps(cfg, dev, params)
    out = {}
    with torch.no_grad():
        for name in ("prefill", "decode"):          # the decode step reads what prefill wrote
            out[name] = roofline_step(name, real[name][0], counted(name), meta[name][1],
                                      real[name][1], 2.0 * n_params * tokens[name])
    del real
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 17: tensor-parallel serving (two or four ranks on the one card)
# ---------------------------------------------------------------------------


def tp_kernel_checks(cfg, dev, gen, rng):
    """(a) K1 bit-equal to its plain version at every per-rank (K, N) of
    tp=2 and tp=4, at a decode step's M and a full admission's; K2 within
    K2_TOL of its plain version on each rank's heads, both pool dtypes,
    with and without holes."""
    from repro_torch.kernels.approx_matmul import approx_matmul, approx_matmul_plain

    d, hq = cfg.d_model, cfg.num_heads * cfg.head_dim
    hkv, ff, vp = cfg.num_kv_heads * cfg.head_dim, cfg.d_ff, cfg.padded_vocab
    k1, k2 = [], []
    for tp in TP_DEGREES:
        for K, N in sorted({(d, hq // tp), (d, hkv // tp), (hq // tp, d), (d, ff // tp),
                            (ff // tp, d), (d, vp // tp)}):
            for M in (NUM_SLOTS, NUM_SLOTS * BUCKETS[-1]):
                a = torch.randint(0, 256, (M, K), generator=gen, device=dev, dtype=torch.uint8)
                b = torch.randint(0, 256, (K, N), generator=gen, device=dev, dtype=torch.uint8)
                out = approx_matmul(a, b, multiplier=cfg.approx.multiplier)
                ref = approx_matmul_plain(a, b, multiplier=cfg.approx.multiplier)
                if out.dtype != torch.int32 or not torch.equal(out, ref):
                    raise AssertionError(f"K1 tp={tp} M={M} K={K} N={N}: "
                                         f"{int((out != ref).sum())} outputs differ")
                k1.append({"tp": tp, "M": M, "K": K, "N": N, "max_abs_err": 0})
        n_kv, g = cfg.num_kv_heads // tp, cfg.num_heads // cfg.num_kv_heads
        for pool, dt in K2_POOLS.items():
            for holes in (False, True):
                args = paged_case(rng, dev, NUM_SLOTS, MAX_LEN // BLOCK_SIZE, BLOCK_SIZE, n_kv,
                                  g, cfg.head_dim, holes=holes, pool_dtype=dt)
                err, err16 = k2_check(f"tp={tp} {pool} holes={holes}", args, BLOCK_SIZE)
                k2.append({"tp": tp, "heads": [n_kv * g, n_kv], "pool": pool, "holes": holes,
                           "max_abs_err": err, "max_abs_err_bf16_q": err16})
    log(f"[tp] (a) K1 bit-equal at {len(k1)} per-rank shapes "
        f"{sorted({(r['K'], r['N']) for r in k1})}; K2 within {K2_TOL} on "
        + json.dumps([(r["tp"], r["heads"], r["pool"], r["holes"], r["max_abs_err"])
                      for r in k2]))
    return k1, k2


def counted_run(sess, trace, admissions=()):
    """``drive(sess, trace)`` with K1's, K2's and the collectives' counts
    zeroed just before ``run()`` and read just after, each MoE routing's
    dropped assignments (``record_drops``: [admission, rows, dropped]) and
    the bytes each expert gather returned: (results, the numbers phases 13,
    17 and 18 gate)."""
    import repro_torch.models.moe as M
    from repro_torch.kernels.approx_matmul import approx_matmul
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.parallel.collectives import COUNTS
    from repro_torch.serve import pool_bytes_per_device

    drops, unpatch = record_drops(admissions)
    gathered, gather = {}, M.all_gather_first

    def counted_gather(t, mesh):
        out = gather(t, mesh)
        gathered[out.nbytes] = gathered.get(out.nbytes, 0) + 1
        return out

    M.all_gather_first = counted_gather
    approx_matmul.launches = paged_attention.launches = 0
    calls, host_s = COUNTS["calls"], COUNTS["host_s"]
    try:
        res, wall = drive(sess, trace)
    finally:
        unpatch()
        M.all_gather_first = gather
    st = sess.stats
    return res, {
        "tokens": {rid: r.tokens.tolist() for rid, r in res.items()},
        "ticks": st.ticks, "admit_calls": st.admit_calls, "wall_s": wall,
        "launches": {"approx_matmul": approx_matmul.launches,
                     "paged_attention": paged_attention.launches},
        "collectives": COUNTS["calls"] - calls, "collective_host_s": COUNTS["host_s"] - host_s,
        "drops": [[i, T, int(n)] for i, T, n in drops], "gathers": gathered,
        "pool_bytes": pool_bytes_per_device(sess.cache), "tp": st.tp, "devices": st.devices}


def tp_rank(rank, world, store_path, job):
    """One rank of a tensor-parallel world on ``job["device"]`` over gloo:
    load the frozen weights ``job["weights"]`` (an mmap of the file), keep
    this rank's part on the card, warm up on the trace's first request cut
    to 1 new token, then serve the trace once per attention path in
    ``job["attn"]`` through ``job["session"]`` ("phase4": phase 4's sync
    session; "family": phase 13's) with the counts zeroed just before
    (``counted_run``).  Returns each run's numbers, the rank's weight
    bytes, load seconds and peak."""
    import torch.distributed as dist

    from repro_torch.kernels._build import build_all
    from repro_torch.launch.mesh import TPMesh
    from repro_torch.models.transformer import params_to
    from repro_torch.parallel.sharding import tree_bytes
    from repro_torch.parallel.tp import shard_params

    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        build_all()                              # loads the libraries phase 1 built
    mesh = TPMesh(rank=rank, world=world, store=dist.FileStore(store_path, world),
                  backend="gloo", device=dev)
    try:
        cfg, seed, trace = job["cfg"], job["seed"], job["trace"]

        def session(attn):
            if job["session"] == "family":
                return family_session(cfg, params, dev, seed, mesh=mesh)
            return share_session(cfg, params, dev, seed, loop="sync", attn_impl=attn,
                                 cache_layout="paged", mesh=mesh)

        t0 = time.perf_counter()
        whole = torch.load(job["weights"], map_location="cpu", mmap=True, weights_only=False)
        params = params_to(shard_params(whole, cfg, mesh), dev)
        del whole
        out = {"load_s": time.perf_counter() - t0, "weight_bytes": tree_bytes(params),
               "expert_bytes": expert_bytes(params) if cfg.family == "moe" else 0, "runs": {}}
        drive(session("kernel"), [(p, 1, 0) for p, _, _ in trace[:1]])      # warm-up
        for attn in job["attn"]:
            out["runs"][attn] = counted_run(session(attn), trace)[1]
        out["peak_reserved_gb"] = (torch.cuda.max_memory_reserved() / 1e9
                                   if dev.type == "cuda" else 0.0)
        return out
    finally:
        mesh.close()


def tie_or_equal(name, cfg, params, trace, got, want):
    """Each request's tokens equal, or equal up to a first divergence where
    the two tokens' logits in ``forward`` over the prompt and the agreed
    tokens lie within NEAR_TIE (the repo's near-tie rule); the gaps."""
    from repro_torch.models.transformer import forward

    gaps = {}
    for rid, w in want.items():
        g = got[rid]
        if g == w:
            continue
        j = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        seq = np.concatenate([trace[rid][0], np.asarray(w[:j], dtype=np.int64)])
        with torch.no_grad():
            logits = forward(cfg, params, torch.as_tensor(seq[None], device=params[
                "final_norm"].device))[0, -1]
        gap = (logits[w[j]] - logits[g[j]]).item()
        gaps[rid] = {"new_token_index": j, "tokens": [g[j], w[j]], "logit_gap": gap}
        log(f"[tp] {name} request {rid}: parts at new token {j} ({g[j]} vs {w[j]}), "
            f"logit gap {gap:.4g}")
        if abs(gap) > NEAR_TIE:
            raise AssertionError(f"{name} request {rid}: {g} vs {w}; the first divergence "
                                 f"is no near tie (logit gap {gap})")
    return gaps


def tp_gates(name, cfg, runs, attn, tp, tp1_pool_bytes):
    """(e) Every rank served the same tokens; per rank and decode tick
    ``k1_per_pass`` K1 launches (plus one pass per admission) and, through
    K2, one K2 launch per layer; each rank's pool is 1/tp of tp=1's."""
    first = runs[0]["runs"][attn]
    for rank, r in enumerate(runs):
        run = r["runs"][attn]
        if run["tokens"] != first["tokens"] or run["ticks"] != first["ticks"]:
            raise AssertionError(f"{name}: rank {rank} served other tokens than rank 0")
        n = run["launches"]
        k1 = k1_per_pass(cfg) * (run["ticks"] + run["admit_calls"])
        k2 = cfg.num_layers * run["ticks"] if attn == "kernel" else 0
        if (n["approx_matmul"], n["paged_attention"]) != (k1, k2):
            raise AssertionError(f"{name} rank {rank}: launches {n}, want K1 {k1} "
                                 f"({k1_per_pass(cfg)} per pass) and K2 {k2}")
        if run["pool_bytes"] * tp != tp1_pool_bytes or (run["tp"], run["devices"]) != (tp, tp):
            raise AssertionError(f"{name} rank {rank}: pool {run['pool_bytes']} B x {tp} != "
                                 f"{tp1_pool_bytes} B, stats tp/devices "
                                 f"{run['tp']}/{run['devices']}")
    return first


def tp_phase(dev, seed, trace, smi):
    """Phase 17 (see the module text)."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.transformer import init_params, params_to
    from repro_torch.serve import freeze_params, pool_bytes_per_device

    t_unit = time.perf_counter()
    cfg = dataclasses.replace(serving_configs()[0], num_layers=FEATURE_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(seed)
    k1, k2 = tp_kernel_checks(cfg, dev, gen, np.random.default_rng(seed))

    # the tp=1 sessions at each world's depth, weights frozen from the seed
    # (tp=2's through the gather and through K2, tp=4's through K2); the
    # ranks load the same weights from a file
    cfg4 = dataclasses.replace(cfg, num_layers=TP4_LAYERS)
    ref = {}
    tmp = tempfile.TemporaryDirectory(prefix="tp_")
    files = {c.num_layers: os.path.join(tmp.name, f"weights{c.num_layers}.pt")
             for c in (cfg, cfg4)}
    for c in (cfg, cfg4):
        p = freeze_params(c, init_params(c, seed=seed, device=dev))
        torch.save(params_to(p, "cpu"), files[c.num_layers])
        serve(c, p, trace[:1], dev, "kernel", seed)                    # warm-up
        for attn in (("gather", "kernel") if c is cfg else ("kernel",)):
            sess, res, wall = serve(c, p, trace, dev, attn, seed)
            ref[(c.num_layers, attn)] = {
                "tokens": {rid: r.tokens.tolist() for rid, r in res.items()},
                "ticks": sess.stats.ticks, "wall_s": wall,
                "pool_bytes": pool_bytes_per_device(sess.cache)}
            del sess
        ref[c.num_layers] = p
        gc.collect()
        torch.cuda.empty_cache()
    log("[tp] one card, gloo over CUDA tensors: the multi-card NCCL path (launch/serve.py "
        "--tp N on N cards) is unchecked here")

    worlds = {}
    with tmp:
        for tp, c, attn in ((2, cfg, ("gather", "kernel")), (4, cfg4, ("kernel",))):
            layers = c.num_layers
            t0 = time.perf_counter()
            job = {"cfg": c, "session": "phase4", "seed": seed, "trace": trace, "attn": attn,
                   "device": str(dev), "weights": files[layers]}
            worlds[tp] = run_ranks(tp_rank, tp, (os.path.join(tmp.name, f"store{tp}"), job),
                                   timeout=900)
            log(f"[tp] tp={tp} world ({tp} ranks, {layers} layers): "
                f"{time.perf_counter() - t0:.1f}s, ranks loaded and cut the weights in "
                + ", ".join(f"{r['load_s']:.1f}s" for r in worlds[tp])
                + ", peak reserved " + ", ".join(f"{r['peak_reserved_gb']:.2f} GB"
                                                 for r in worlds[tp]))

    report = {"k1_checked": len(k1), "k2": k2, "near_ties": {}, "runs": {}, "launches": {}}
    for tp, layers, attn in ((2, cfg.num_layers, "gather"), (2, cfg.num_layers, "kernel"),
                             (4, TP4_LAYERS, "kernel")):
        c = cfg if layers == cfg.num_layers else cfg4
        name = f"tp={tp} {layers} layers {attn}"
        one = ref[(layers, attn)]
        run = tp_gates(name, c, worlds[tp], attn, tp, one["pool_bytes"])
        want = {rid: list(t) for rid, t in one["tokens"].items()}
        if attn == "gather":                                         # (b) identical
            same_tokens(name, [run["tokens"][r] for r in sorted(want)],
                        [want[r] for r in sorted(want)])
        else:                                                        # (c), (d)
            report["near_ties"][name] = tie_or_equal(name, c, ref[layers], trace,
                                                     run["tokens"], want)
        if run["ticks"] != one["ticks"]:
            raise AssertionError(f"{name}: {run['ticks']} ticks, tp=1 {one['ticks']}")
        row = {"tp": tp, "layers": layers, "attn": attn, "ticks": run["ticks"],
               "identical_tokens": run["tokens"] == want,
               "host_ms_per_tick": 1e3 * run["wall_s"] / run["ticks"],
               "tp1_host_ms_per_tick": 1e3 * one["wall_s"] / one["ticks"],
               "collectives_per_tick": run["collectives"] / run["ticks"],
               "collective_host_ms_per_tick": 1e3 * run["collective_host_s"] / run["ticks"],
               "launches_per_rank": run["launches"], "pool_bytes_per_rank": run["pool_bytes"],
               "tp1_pool_bytes": one["pool_bytes"],
               "k1_per_decode_tick": k1_per_pass(c), "k2_per_decode_tick":
               c.num_layers if attn == "kernel" else 0}
        report["runs"][name] = row
        report["launches"][f"tp{tp}_{attn}"] = {
            k: sum(r["runs"][attn]["launches"][k] for r in worlds[tp])
            for k in ("approx_matmul", "paged_attention")}
        log(f"[tp] {name}: {json.dumps(row)}")
    report["seconds"] = time.perf_counter() - t_unit
    log(f"[tp] phase 17 took {report['seconds']:.1f}s (gloo on one card, {smi})")
    return report


# ---------------------------------------------------------------------------
# phase 18: MoE expert parallelism (two or four ranks on the one card)
# ---------------------------------------------------------------------------


def expert_bytes(params):
    """Bytes of the routed experts' codes (``w_gate``, ``w_up``, ``w_down``;
    a ``Shard``'s part)."""
    from repro_torch.core.approx import Shard

    moe = params["layers"]["moe"]
    return sum((w.w if isinstance(w, Shard) else w).codes.nbytes
               for w in (moe["w_gate"], moe["w_up"], moe["w_down"]))


def ep_kernel_checks(cfg, dev, gen, rng, m_adm):
    """(a) K1 bit-equal to its plain version at every per-rank (K, N) this
    phase adds: the shared expert's, attention's and the head's at tp=2
    and tp=4, and an expert's own column/row parts at EP_COLROW_TP (where
    60 experts do not divide the ranks), at M = 4, the decode capacity (8)
    and the first admission's rows; K2 within K2_TOL of its plain version
    at each rank's heads (hd 128), both pool dtypes, with and without
    holes."""
    from repro_torch.kernels.approx_matmul import approx_matmul, approx_matmul_plain
    from repro_torch.models.moe import moe_capacity

    d, hq, sff = cfg.d_model, cfg.num_heads * cfg.head_dim, cfg.moe_shared_ff
    cap = moe_capacity(NUM_SLOTS, cfg.moe_top_k, cfg.moe_experts, cfg.capacity_factor)
    shapes = {(K, N) for tp in EP_DEGREES for K, N in (
        (d, sff // tp), (sff // tp, d), (d, hq // tp), (hq // tp, d), (d, cfg.padded_vocab // tp))}
    shapes |= {(d, cfg.d_ff // EP_COLROW_TP), (cfg.d_ff // EP_COLROW_TP, d)}
    k1, k2 = [], []
    for K, N in sorted(shapes):
        for M in sorted({NUM_SLOTS, cap, m_adm}):
            a = torch.randint(0, 256, (M, K), generator=gen, device=dev, dtype=torch.uint8)
            b = torch.randint(0, 256, (K, N), generator=gen, device=dev, dtype=torch.uint8)
            out = approx_matmul(a, b, multiplier=cfg.approx.multiplier)
            ref = approx_matmul_plain(a, b, multiplier=cfg.approx.multiplier)
            if out.dtype != torch.int32 or not torch.equal(out, ref):
                raise AssertionError(f"[ep] K1 M={M} K={K} N={N}: "
                                     f"{int((out != ref).sum())} outputs differ")
            k1.append([M, K, N])
    g = cfg.num_heads // cfg.num_kv_heads
    for tp in EP_DEGREES:
        n_kv = cfg.num_kv_heads // tp
        for pool, dt in K2_POOLS.items():
            for holes in (False, True):
                args = paged_case(rng, dev, NUM_SLOTS, FAMILY_MAX_LEN // BLOCK_SIZE, BLOCK_SIZE,
                                  n_kv, g, cfg.head_dim, holes=holes, pool_dtype=dt)
                err, err16 = k2_check(f"ep tp={tp} {pool} holes={holes}", args, BLOCK_SIZE)
                k2.append({"tp": tp, "heads": [n_kv * g, n_kv], "pool": pool, "holes": holes,
                           "max_abs_err": err, "max_abs_err_bf16_q": err16})
    log(f"[ep] (a) K1 bit-equal at (M, K, N) {k1}; K2 within {K2_TOL} on "
        + json.dumps([(r["tp"], r["heads"], r["pool"], r["holes"], r["max_abs_err"])
                      for r in k2]))
    return k1, k2


def ep_gates(name, cfg, tp, runs, one, passes, whole_expert_bytes):
    """(d) On every rank: rank 0's tokens and ticks, tp=1's ticks and
    dropped assignments, K1's launches ``k1_per_pass(cfg, tp)`` per pass
    (tp=1's passes), K2's tp=1's (one per layer per decode tick),
    ``collectives_per_pass`` per pass, 1/tp of tp=1's pool and of the
    whole model's expert codes, stats.tp and devices."""
    from repro_torch.launch.dryrun import collectives_per_pass

    k1 = k1_per_pass(cfg, tp) * passes
    coll = collectives_per_pass(cfg, tp) * passes
    drops = [d[1:] for d in one["drops"]]
    for rank, r in enumerate(runs):
        run, bad = r["runs"]["kernel"], []
        if run["tokens"] != runs[0]["runs"]["kernel"]["tokens"]:
            bad.append("tokens differ from rank 0's")
        if (run["ticks"], [d[1:] for d in run["drops"]]) != (one["ticks"], drops):
            bad.append(f"ticks {run['ticks']} and drops {run['drops']} against tp=1's "
                       f"{one['ticks']} and {one['drops']}")
        n = run["launches"]
        if (n["approx_matmul"], n["paged_attention"]) != (k1, one["launches"]["paged_attention"]):
            bad.append(f"launches {n}, want K1 {k1} ({k1_per_pass(cfg, tp)} per pass x "
                       f"{passes}) and K2 {one['launches']['paged_attention']}")
        if run["collectives"] != coll:
            bad.append(f"{run['collectives']} collectives, want {coll} "
                       f"({collectives_per_pass(cfg, tp)} per pass)")
        if run["pool_bytes"] * tp != one["pool_bytes"]:
            bad.append(f"pool {run['pool_bytes']} B x {tp} != {one['pool_bytes']} B")
        if r["expert_bytes"] * tp != whole_expert_bytes:
            bad.append(f"expert codes {r['expert_bytes']} B x {tp} != {whole_expert_bytes} B")
        if (run["tp"], run["devices"]) != (tp, tp):
            bad.append(f"stats tp/devices {run['tp']}/{run['devices']}")
        if bad:
            raise AssertionError(f"[ep] {name} rank {rank}: " + "; ".join(bad))


def ep_save(params, tmp, name):
    """Phase 18's hand-over: the unit's frozen weights copied to host
    memory (the caller then frees them on the card) and written to a file
    under ``tmp`` by a thread while the unit goes on; ``saved["wait"]()``
    joins it, raising its error.  Also the whole model's expert-code bytes."""
    from repro_torch.models.transformer import params_to

    cpu = params_to(params, "cpu")
    saved, errors = {"weights": os.path.join(tmp, name), "expert_bytes": expert_bytes(params)}, []

    def write():
        t0 = time.perf_counter()
        try:
            torch.save(cpu, saved["weights"])
        except BaseException as e:              # raised again by wait()
            errors.append(e)
        saved["save_s"] = time.perf_counter() - t0

    thread = threading.Thread(target=write, name=f"save {name}", daemon=True)
    thread.start()

    def wait():
        thread.join()
        if errors:
            raise errors[0]
        saved["file_gb"] = os.path.getsize(saved["weights"]) / 1e9

    saved["wait"] = wait
    return saved


def ep_world(cfg, tp, saved, one, trace, dev, seed):
    """Phase 18's world of ``tp`` ranks on the one card: ``tp_rank``
    serves ``trace`` through phase 13's session on the weights ``saved``
    (``ep_save``), held to the unit's own tp=1 run ``one`` of the same
    weights (``counted_run``'s numbers): (d) by ``ep_gates``, then the
    tokens by the near-tie rule.  Returns
    the printed row and the ranks' launches."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.transformer import params_to

    saved["wait"]()
    name = f"tp={tp} {cfg.num_layers} layers"
    passes, rest = divmod(one["launches"]["approx_matmul"], k1_per_pass(cfg))
    if rest or one["launches"]["paged_attention"] != cfg.num_layers * one["ticks"]:
        raise AssertionError(f"[ep] tp=1 at {cfg.num_layers} layers: launches "
                             f"{one['launches']} over {one['ticks']} ticks are not whole passes")
    t0 = time.perf_counter()
    job = {"cfg": cfg, "session": "family", "seed": seed, "trace": trace, "attn": ("kernel",),
           "device": str(dev), "weights": saved["weights"]}
    ranks = run_ranks(tp_rank, tp, (saved["weights"] + ".store", job), timeout=900)
    world_s = time.perf_counter() - t0
    log(f"[ep] {name} world: {world_s:.1f}s, ranks loaded and cut the weights in "
        + ", ".join(f"{r['load_s']:.1f}s" for r in ranks)
        + ", peak reserved " + ", ".join(f"{r['peak_reserved_gb']:.2f} GB" for r in ranks))
    ep_gates(name, cfg, tp, ranks, one, passes, saved["expert_bytes"])
    run, near = ranks[0]["runs"]["kernel"], {}
    if run["tokens"] != one["tokens"]:                  # (b), (c): the near-tie rule
        held = params_to(torch.load(saved["weights"], map_location="cpu", mmap=True,
                                    weights_only=False), dev)
        near = tie_or_equal(f"[ep] {name}", cfg, held, trace, run["tokens"], one["tokens"])
        del held
    row = {"tp": tp, "layers": cfg.num_layers, "ticks": run["ticks"], "passes": passes,
           "identical_tokens": run["tokens"] == one["tokens"], "near_ties": near,
           "world_s": world_s, "save_s": saved["save_s"], "file_gb": saved["file_gb"],
           "host_ms_per_tick": 1e3 * run["wall_s"] / run["ticks"],
           "tp1_host_ms_per_tick": 1e3 * one["wall_s"] / one["ticks"],
           "collectives_per_pass": run["collectives"] / passes,
           "collectives_per_tick": run["collectives"] / run["ticks"],
           "collective_host_ms_per_tick": 1e3 * run["collective_host_s"] / run["ticks"],
           "gathered_mb_per_tick": sum(b * n for b, n in run["gathers"].items())
           / 1e6 / run["ticks"],
           "gathers_by_bytes": run["gathers"],
           "k1_per_pass": k1_per_pass(cfg, tp), "tp1_k1_per_pass": k1_per_pass(cfg),
           "launches_per_rank": run["launches"],
           "dropped_assignments": sum(d[2] for d in run["drops"]),
           "pool_bytes_per_rank": run["pool_bytes"], "tp1_pool_bytes": one["pool_bytes"],
           "expert_gb_per_rank": ranks[0]["expert_bytes"] / 1e9,
           "tp1_expert_gb": saved["expert_bytes"] / 1e9,
           "rank_weight_gb": [r["weight_bytes"] / 1e9 for r in ranks],
           "rank_peak_reserved_gb": [r["peak_reserved_gb"] for r in ranks]}
    log(f"[ep] {name}: {json.dumps(row)}")
    return row, {k: sum(r["runs"]["kernel"]["launches"][k] for r in ranks)
                 for k in ("approx_matmul", "paged_attention")}


# ---------------------------------------------------------------------------
# phase 19: data-parallel FSDP training (two or four ranks on the one card)
# ---------------------------------------------------------------------------


def dp_config(layers):
    """granite-3-2b at its widths, ``layers`` deep, trained as
    ``launch/train.py`` trains (mul8x8_2 through K1, band_reg 1e-4, remat
    on: the config's default)."""
    return train_config(ARCH, layers)


def dp_mesh_sizes(spec):
    """(dp, tp, pod) of a mesh string of DP_WORLDS."""
    from repro_torch.launch.mesh import parse_mesh

    n = parse_mesh(spec, 1).shape
    return n.get("data", 1), n.get("model", 1), n.get("pod", 1)


def dp_kernel_checks(cfg, dev, gen):
    """(a) K1 bit-equal to its plain version at every (K, N) of granite's
    seven projections at a dp=2 rank's M, at every per-rank shape of the
    other meshes of DP_WORLDS, fused too (``k1_shapes_per_rank``), and at
    every per-rank shape of each family's dp=2 step (phase 19 (b))."""
    from repro_torch.kernels.approx_matmul import approx_matmul, approx_matmul_plain

    fused = dataclasses.replace(cfg, fuse_qkv=True, fuse_gate_up=True)
    todo = set()
    for spec in DP_WORLDS:
        dp, tp, pod = dp_mesh_sizes(spec)
        for c in (cfg, fused):
            todo |= set(k1_shapes_per_rank(c, TRAIN_BATCH * TRAIN_SEQ, dp, tp=tp, pod=pod))
    for arch in FAMILY_ARCHS + BACKBONE_ARCHS:
        todo |= set(k1_shapes_per_rank(train_config(arch, 1), TRAIN_BATCH * TRAIN_SEQ, DP))
    checked = []
    for M, K, N in sorted(todo):
        a = torch.randint(0, 256, (M, K), generator=gen, device=dev, dtype=torch.uint8)
        b = torch.randint(0, 256, (K, N), generator=gen, device=dev, dtype=torch.uint8)
        out = approx_matmul(a, b, multiplier=cfg.approx.multiplier)
        ref = approx_matmul_plain(a, b, multiplier=cfg.approx.multiplier)
        if out.dtype != torch.int32 or not torch.equal(out, ref):
            raise AssertionError(f"K1 M={M} K={K} N={N}: "
                                 f"{int((out != ref).sum())} outputs differ")
        checked.append((M, K, N))
        del a, b, out, ref
    log(f"[dp] (a) K1 bit-equal at {len(checked)} (M, K, N): {checked}")
    return checked


def dp_batches(cfg, seed, dev):
    """DP_STEPS global batches of ``token_batches`` from ``seed``."""
    from repro_torch.data.synthetic import token_batches
    from repro_torch.train.loop import as_batch

    pairs = token_batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=seed)
    return [as_batch(next(pairs), dev) for _ in range(DP_STEPS)]


def dp_whole_leaves(state, cfg, mesh):
    """(group, whole leaf) for each parameter and moment leaf of the rank's
    state, in flatten order: every rank takes part in each gather (over
    the data axis, then the model axis), rank 0 keeps the whole leaf and
    the others None, so no rank holds more than one gathered leaf at a
    time beyond what rank 0 keeps."""
    from repro_torch.parallel import fsdp
    from repro_torch.train.tree import leaves

    dims = fsdp.split_dims(cfg, fsdp.mesh_shape(mesh))
    for group, tree in (("params", state["params"]), ("m", state["opt"]["m"]),
                        ("v", state["opt"]["v"])):
        for t, d in zip(leaves(tree), dims):
            w = fsdp.join_leaf(t, d, mesh)
            yield group, (w.clone() if mesh.rank == 0 else None)
            del w


class DpClose:
    """Gate (c)'s state tolerance against one device's step from the same
    state, leaf by leaf: each moment within 2**-4 of its leaf's largest
    (``allclose`` as the CPU tests hold it), each parameter within 2.1 lr,
    and on a first step (``sure``: AdamW moves a weight by lr times the
    sign of its gradient) within ``move`` (1e-3 lr; a family whose codes
    flip more, ``SURE_MOVE``, its own tolerance) where its moment exceeds
    twice 2**-6 of the leaf's largest, each parameter bound plus four float32
    ulps of the weight (the warm-up's lr, 3e-6 at step 1, is below a
    weight's ulp).  On the card a row's float32 product rounds by the
    batch's M (the library picks its kernel by shape), so the quantizers
    flip codes downstream and the moments part more than on the CPU,
    where ``tests/test_torch_dp.py`` holds the same comparison to 2**-9:
    2**-4 is the repo's tolerance for a quantized step whose codes flip
    (``tests/test_torch_train_families.py``).  ``worst`` holds the
    largest gaps (in lr for the parameters, the ulps taken off),
    ``leaves`` each leaf's; ``ok`` whether all held."""

    TOL, SURE = 2.0 ** -4, 2.0 ** -6

    def __init__(self, lr, sure, move=1e-3):
        self.lr, self.sure, self.move, self.ok = lr, sure, move, True
        self.worst = {"moment_rel": 0.0, "param_lr": 0.0, "sure_param_lr": 0.0}
        self.leaves = {}              # "group path" -> its gap, for the report

    def moment(self, a, b, where=""):
        bmax = b.abs().max()
        gap = ((a - b).abs().max() / bmax.clamp(min=1e-30)).item()
        self.worst["moment_rel"] = max(self.worst["moment_rel"], gap)
        self.leaves[where] = gap
        self.ok &= bool(((a - b).abs() <= self.TOL * (b.abs() + bmax)).all())

    def param(self, a, b, m, where=""):
        d = ((a - b).abs() - 2.0 ** -21 * b.abs()).clamp(min=0) / self.lr
        m = m.abs()
        certain = m > 2 * self.SURE * m.max()
        sure = d[certain].max().item() if certain.any() else 0.0
        self.worst["param_lr"] = max(self.worst["param_lr"], d.max().item())
        self.worst["sure_param_lr"] = max(self.worst["sure_param_lr"], sure)
        self.leaves[where] = [d.max().item(), sure]
        self.ok &= d.max().item() <= 2.1 and (not self.sure or sure <= self.move)


def dp_rank(rank, world, store_path, job):
    """One rank of phase 19's world of ``world`` ranks on ``job["device"]``
    over gloo, which runs every mesh of ``job["meshes"]`` in turn, each
    carved from it (``carve_mesh``: the mesh's first ranks; the others
    wait at a barrier), so the ranks start once: {mesh: ``dp_mesh``'s
    report}.  Between meshes every rank frees its cached blocks and the
    unit moves to its next budget."""
    import torch.distributed as dist

    from repro_torch.kernels._build import build_all
    from repro_torch.launch.mesh import DataMesh, carve_mesh, mesh_ranks, parse_mesh

    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        build_all()                              # loads the libraries phase 1 built
    everyone = DataMesh(rank=rank, world=world, store=dist.FileStore(store_path, world),
                        backend="gloo", device=dev)
    try:
        shapes = {spec: parse_mesh(spec, 1) for spec in job["meshes"]}
        meshes = {spec: carve_mesh(shape, range(mesh_ranks(shape)), dev)
                  for spec, shape in shapes.items()}
        out = {}
        for spec, mesh in meshes.items():
            if mesh is not None:
                out[spec] = dp_mesh(mesh, {**job, **job["meshes"][spec]}, dev)
            dist.barrier(group=everyone.group)
            gc.collect()
            torch.cuda.empty_cache()
            next_budget()
        return out
    finally:
        everyone.close()


def dp_mesh(mesh, job, dev):
    """One rank of a training mesh (a ``TrainMesh``): its part of the
    seeded state (``fsdp.init_state``), then DP_STEPS
    steps of ``make_train_step(mesh=)`` on the global batches, each with
    K1's count and the collectives zeroed just before and read just after
    (and the bytes its all-gathers returned).  Rank 0 holds each step to
    one device's from the same state: it steps the seed's whole state
    (then the state it gathered after the step before) without a mesh
    while the others wait in their step's first collective, and compares
    the step's new state, gathered leaf by leaf, with it (``DpClose``);
    the gathered state starts its next one-device step.  With
    ``job["ckpt"]`` rank 0 writes the last state whole; with
    ``job["restore"]`` every rank restores that checkpoint into its blocks
    after the steps (and digests them).  Returns its steps, launches,
    state bytes, peak and the digest of its parts."""
    import torch.distributed as dist

    import repro_torch.parallel.collectives as C
    from repro_torch.kernels.approx_matmul import approx_matmul
    from repro_torch.parallel import fsdp
    from repro_torch.parallel.sharding import tree_bytes
    from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.train.loop import init_state, make_train_step
    from repro_torch.train.tree import leaves, unflatten

    cfg, opt, seed, rank = job["cfg"], job["opt"], job["seed"], mesh.rank
    torch.cuda.reset_peak_memory_stats()
    t_mesh = time.perf_counter()
    # rank 0's one-device state: the seed's whole state first (the others
    # wait in their first collective), then each step's gathered state
    # (gathered once, after the step)
    start = init_state(cfg, opt, seed, device=dev) if rank == 0 else None
    gathered = [0]
    gather = dist.all_gather_into_tensor

    def counted_gather(out, t, **kw):
        gathered[0] += out.nbytes
        return gather(out, t, **kw)

    try:
        state = fsdp.init_state(cfg, opt, seed, mesh, device=dev)
        out = {"state_bytes": tree_bytes(state), "steps": []}
        step, one_device = make_train_step(cfg, opt, mesh=mesh), make_train_step(cfg, opt)
        paths = [p for p, _, _ in fsdp.leaf_specs(cfg, fsdp.mesh_shape(mesh))]
        launches = 0
        for k, batch in enumerate(dp_batches(cfg, seed, dev), 1):
            row = {}
            if rank == 0:                        # one device's step from the same state
                t0 = time.perf_counter()
                ref, m = one_device(start, batch)
                row.update(ref_loss=m["loss"].item(), ref_host_s=time.perf_counter() - t0,
                           lr=m["lr"].item())
                del start
            C.dist.all_gather_into_tensor = counted_gather
            calls, host_s, gathered[0] = C.COUNTS["calls"], C.COUNTS["host_s"], 0
            approx_matmul.launches = 0
            t0 = time.perf_counter()
            state, m = step(state, batch)
            row.update(loss=m["loss"].item(), host_s=time.perf_counter() - t0,
                       collectives=C.COUNTS["calls"] - calls,
                       collective_host_s=C.COUNTS["host_s"] - host_s,
                       gathered_bytes=gathered[0])
            launches += approx_matmul.launches
            C.dist.all_gather_into_tensor = gather
            t0 = time.perf_counter()
            close = DpClose(row["lr"], sure=k == 1) if rank == 0 else None
            want = ({"params": leaves(ref["params"]), "m": leaves(ref["opt"]["m"]),
                     "v": leaves(ref["opt"]["v"])} if rank == 0 else None)
            seen = {"params": [], "m": [], "v": []}
            for group, w in dp_whole_leaves(state, cfg, mesh):
                if rank == 0:
                    i = len(seen[group])
                    where = f"{group} {paths[i]}"
                    if group == "params":
                        close.param(w, want["params"][i], want["m"][i], where)
                    else:
                        close.moment(w, want[group][i], where)
                    seen[group].append(w)
            if rank == 0:
                row.update(close=close.worst, close_ok=close.ok, close_by_leaf=close.leaves,
                           compare_s=time.perf_counter() - t0)
                start = {"params": unflatten(state["params"], seen["params"]),
                         "opt": {"step": state["opt"]["step"].clone(),
                                 "m": unflatten(state["opt"]["m"], seen["m"]),
                                 "v": unflatten(state["opt"]["v"], seen["v"])}}
                del ref, want, seen
            out["steps"].append(row)
        del start
        out["launches"] = launches
        out["state_bytes_after"] = tree_bytes(state)
        out["digest"] = state_digest(state)
        out["peak_allocated_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                                    if dev.type == "cuda" else 0.0)
        out["peak_reserved_gb"] = (torch.cuda.max_memory_reserved() / 1e9
                                   if dev.type == "cuda" else 0.0)
        if job["ckpt"]:
            t0 = time.perf_counter()
            save_checkpoint(job["ckpt"], DP_STEPS, state, cfg=cfg, mesh=mesh)
            out["ckpt_s"] = time.perf_counter() - t0
        if job["restore"]:
            t0 = time.perf_counter()
            back, at = restore_checkpoint(job["restore"], state, cfg=cfg, mesh=mesh)
            out.update(restored_at=at, restored_digest=state_digest(back),
                       restore_s=time.perf_counter() - t0)
            del back
        out["mesh_s"] = time.perf_counter() - t_mesh
        return out
    finally:
        C.dist.all_gather_into_tensor = gather


def family_batches(cfg, seed, dev):
    """Phase 14's (and 15's) global training batches, TRAIN_STEPS_FAMILY
    and one more for the profiled step, drawn alike on every rank: token
    batches of ``token_batches`` from ``seed``, or for a model without
    token inputs seeded embeddings (and the vlm's positions grid) with
    labels, from a generator on the card."""
    from repro_torch.data.synthetic import token_batches
    from repro_torch.train.loop import as_batch

    n = TRAIN_STEPS_FAMILY + 1
    if cfg.embed_input:
        pairs = token_batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=seed)
        return [as_batch(next(pairs), dev) for _ in range(n)]
    gen = torch.Generator(device=dev).manual_seed(seed + 16)
    out = []
    for _ in range(n):
        e, p = embedding_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, gen, dev)
        labels = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ), generator=gen,
                               device=dev)
        out.append({"embeddings": e, "labels": labels,
                    **({"positions_thw": p} if p is not None else {})})
    return out


class DropLog:
    """Each ``moe.route`` call's dropped assignments while installed, kept
    on the card until ``take`` reads them."""

    def __init__(self):
        import repro_torch.models.moe as moe

        self.moe, self.route, self.drops = moe, moe.route, []

        def route(*a, **kw):
            r = self.route(*a, **kw)
            self.drops.append((~r.keep).sum())
            return r

        moe.route = route

    def take(self):
        out, self.drops = [int(t) for t in self.drops], []
        return out

    def close(self):
        self.moe.route = self.route


def rank_part(t, dim, rank, size):
    """Rank ``rank``'s part of the whole leaf ``t`` along ``dim`` (from the
    end; None: the whole leaf) on a data axis of ``size``, as the FSDP
    rules cut it."""
    if dim is None:
        return t.detach()
    n = t.shape[dim] // size
    return t.detach().narrow(dim, rank * n, n)


def train_dp_rank(rank, world, store_path, job):
    """Phase 14's (or 15's) training steps of one family and phase 19
    (b)'s data-parallel world of it, as ranks of one world on the card over
    gloo.  Rank 0 first takes phase 14's steps on one device's state from
    the seed (K1's count zeroed just before each and read just after: that
    path's launches); after each it keeps in host memory its own part of
    the new state (the FSDP rules' cut of the parameters and both moments),
    and after the first it sends every other rank its part (gloo, host
    tensors, while it goes on); then it takes phase 14's profiled step and
    frees the state.  Rank 0 runs in the calling process
    (``run_ranks(rank0_here=True)``) and draws one device's state before
    it joins the mesh, so the others start up meanwhile.  Then every rank takes
    the dp steps (``make_train_step(mesh=)``) from its part of the seed's
    draw (``fsdp.init_state``) on the same global batches, K1's count, the
    collectives and the gathered bytes zeroed just before each step and
    read just after, and holds its new part to its part of the one-device
    step's state leaf by leaf (``DpClose``: rank 0 at every step, the
    others at the first); before step 2 each rank sets its part to the
    one-device state after step 1, so every dp step starts from the state
    its one-device step started from (rank 0's loss gates step 2, which
    reads every rank's part).  A MoE's
    dropped assignments are logged per routing call on both sides.
    Returns rank 0's phase-14 rows and each rank's dp numbers."""
    import torch.distributed as dist

    import repro_torch.parallel.collectives as C
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.approx_matmul import approx_matmul
    from repro_torch.launch.mesh import DataMesh
    from repro_torch.parallel import fsdp
    from repro_torch.parallel.sharding import tree_bytes
    from repro_torch.train.loop import init_state, make_train_step
    from repro_torch.train.tree import leaves

    t_rank = time.perf_counter()
    seconds = {}

    def lap(part):
        nonlocal t_rank
        now = time.perf_counter()
        seconds[part] = now - t_rank
        t_rank = now

    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        build_all()                              # loads the libraries phase 1 built
    cfg, opt, seed = job["cfg"], job["opt"], job["seed"]
    if rank == 0:                                # drawn while the others start up
        torch.cuda.reset_peak_memory_stats()
        one = init_state(cfg, opt, seed, device=dev)
        lap("one_device_init")
    mesh = DataMesh(rank=rank, world=world, store=dist.FileStore(store_path, world),
                    backend="gloo", device=dev)
    gathered = [0]
    gather = dist.all_gather_into_tensor

    def counted_gather(out, t, **kw):
        gathered[0] += out.nbytes
        return gather(out, t, **kw)

    drops = DropLog() if cfg.family == "moe" else None
    groups = ("params", "m", "v")
    lap("start")
    try:
        batches = family_batches(cfg, seed, dev)
        specs = fsdp.leaf_specs(cfg, mesh.size)
        dims = fsdp.data_dims(cfg, mesh.size)
        shapes = [tuple(n // mesh.size if i - len(shape) == d else n
                        for i, n in enumerate(shape))
                  for (_, shape, _), d in zip(specs, dims)]
        out = {"dp_steps": [], "launches": 0, "dp_launches": 0, "seconds": seconds}
        refs, sends = [], []                     # the rank's part of each one-device state
        if rank == 0:                            # phase 14's steps: the reference
            one_step = make_train_step(cfg, opt)
            out.update(params=sum(p.numel() for p in leaves(one["params"])), steps=[])
            for batch in batches[:-1]:
                torch.cuda.synchronize()
                n0, t0 = approx_matmul.launches, time.perf_counter()
                one, m = one_step(one, batch)
                row = {"loss": m["loss"].item(), "ce": m["ce"].item(), "aux": m["aux"].item(),
                       "band_reg": m["band_reg"].item(), "lr": m["lr"].item(),
                       "host_s": time.perf_counter() - t0}
                out["launches"] += approx_matmul.launches - n0
                if drops is not None:
                    row["dropped_by_call"] = drops.take()
                out["steps"].append(row)
                del m
                t0 = time.perf_counter()
                trees = [leaves(one["params"]), leaves(one["opt"]["m"]), leaves(one["opt"]["v"])]
                for r in range(mesh.size if len(refs) == 0 else 1):
                    parts = {g: [rank_part(t, d, r, mesh.size).to("cpu", copy=True)
                                 for t, d in zip(tree, dims)]
                             for g, tree in zip(groups, trees)}
                    if r == 0:
                        refs.append(parts)
                        continue
                    for g in groups:           # sent while the next steps run
                        sends += [(t, dist.isend(t, dst=r, group=mesh.group)) for t in parts[g]]
                    del parts
                del trees
                row["send_s"] = time.perf_counter() - t0
            lap("one_device_steps")
            holder = {}

            def profiled():
                holder["state"], holder["m"] = one_step(one, batches[-1])
            out["profiled_step"] = profile_step(profiled)
            out["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                              if dev.type == "cuda" else 0.0)
            del holder, one
            lap("profiled_step")
            for _, work in sends:
                work.wait()
            del sends
            lap("sends_done")
            if drops is not None:
                drops.take()
            next_budget()                        # the unit's: its dp world's
        else:                                    # the first one-device state's part, from rank 0
            for _ in batches[:1]:
                parts = {}
                for g in groups:
                    parts[g] = []
                    for shape in shapes:
                        t = torch.empty(shape, dtype=torch.float32)
                        dist.recv(t, src=0, group=mesh.group)
                        parts[g].append(t)
                refs.append(parts)
        C.barrier(mesh)                          # the others wait for the reference
        lap("reference")
        torch.cuda.reset_peak_memory_stats()
        part = fsdp.init_state(cfg, opt, seed, mesh, device=dev)
        out["state_bytes"] = tree_bytes(part)
        lap("part_init")
        step = make_train_step(cfg, opt, mesh=mesh)
        paths = [p for p, _, _ in specs]
        for k, batch in enumerate(batches[:-1], 1):
            if k > 1:                            # start where the one-device step did
                with torch.no_grad():
                    for g, tree in zip(groups, (part["params"], part["opt"]["m"],
                                                part["opt"]["v"])):
                        for t, ref in zip(leaves(tree), refs[k - 2][g]):
                            t.copy_(ref)
            C.dist.all_gather_into_tensor = counted_gather
            calls, host_s, gathered[0] = C.COUNTS["calls"], C.COUNTS["host_s"], 0
            torch.cuda.synchronize()
            n0, t0 = approx_matmul.launches, time.perf_counter()
            part, m = step(part, batch)
            row = {"loss": m["loss"].item(), "aux": m["aux"].item(), "lr": m["lr"].item(),
                   "host_s": time.perf_counter() - t0,
                   "collectives": C.COUNTS["calls"] - calls,
                   "collective_host_s": C.COUNTS["host_s"] - host_s,
                   "gathered_bytes": gathered[0]}
            out["dp_launches"] += approx_matmul.launches - n0
            C.dist.all_gather_into_tensor = gather
            if drops is not None:
                row["dropped_by_call"] = drops.take()
            out["dp_steps"].append(row)
            del m
            if k > len(refs):                        # rank 1 holds the first state's part only
                continue
            t0 = time.perf_counter()                 # the rank's part against one device's
            close = DpClose(row["lr"], sure=k == 1, move=SURE_MOVE.get(cfg.family, 1e-3))
            for i, (p_, m_, v_) in enumerate(zip(leaves(part["params"]),
                                                 leaves(part["opt"]["m"]),
                                                 leaves(part["opt"]["v"]))):
                want = {g: refs[k - 1][g][i].to(dev) for g in groups}
                close.param(p_.detach(), want["params"], want["m"], f"params {paths[i]}")
                close.moment(m_, want["m"], f"m {paths[i]}")
                close.moment(v_, want["v"], f"v {paths[i]}")
                del want
            row.update(close=close.worst, close_ok=close.ok, close_by_leaf=close.leaves,
                       compare_s=time.perf_counter() - t0)
            if rank == 0:
                row["ref_loss"] = out["steps"][k - 1]["loss"]
        del refs
        lap("dp_steps")
        out["state_bytes_after"] = tree_bytes(part)
        out["peak_allocated_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                                    if dev.type == "cuda" else 0.0)
        out["peak_reserved_gb"] = (torch.cuda.max_memory_reserved() / 1e9
                                   if dev.type == "cuda" else 0.0)
        return out
    finally:
        C.dist.all_gather_into_tensor = gather
        if drops is not None:
            drops.close()
        mesh.close()


def train_dp_world(cfg, opt, seed, dev, name):
    """Phase 14's (or 15's) steps of one family and phase 19 (b)'s dp=2
    world of it (``train_dp_rank``), gated: phase 14's K1 launches, finite
    losses, a positive load-balance term and the profiled step's device
    time; each dp step's loss within DP_LOSS_RTOL of the one-device step's
    from the same state and each rank's compared new part within
    ``DpClose`` of its cut of the one-device state, every rank the same
    losses, each rank's K1 launches and collectives the counts'
    (``k1_per_train_step``, ``collectives_per_train_step``) and its state
    bytes the rules'.  Returns (phase 14's report, phase 19's row, the dp
    path's launches)."""
    from repro_torch.launch.dryrun import gathered_bytes_per_train_step
    from repro_torch.launch.mesh import run_ranks

    dp = DP
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dp_family_") as tmp:
        job = {"cfg": cfg, "opt": opt, "seed": seed, "device": str(dev)}
        ranks = run_ranks(train_dp_rank, dp, (os.path.join(tmp, "store"), job),
                          timeout=900, rank0_here=True)
    world_s = time.perf_counter() - t0
    next_budget()                                # the unit's after its dp world
    r0 = ranks[0]
    out = {"layers": cfg.num_layers, "params": r0["params"],
           "k1_predicted_per_step": k1_per_train_step(cfg), "steps": r0["steps"],
           "launches": r0["launches"], "peak_gb": r0["peak_gb"],
           "profiled_step": r0["profiled_step"]}
    log(f"[{name}] {json.dumps(out)}")
    losses = [st["loss"] for st in out["steps"]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[{name}] training losses not finite: {losses}")
    if cfg.family == "moe" and not all(st["aux"] > 0 for st in out["steps"]):
        raise AssertionError(f"[{name}] the load-balance term is not positive: {out['steps']}")
    if out["launches"] != TRAIN_STEPS_FAMILY * out["k1_predicted_per_step"]:
        raise AssertionError(f"[{name}] K1 launched {out['launches']} times in "
                             f"{TRAIN_STEPS_FAMILY} steps, predicted "
                             f"{out['k1_predicted_per_step']} per step")
    if not out["profiled_step"].get("k1_device_ms", 0) > 0:
        raise AssertionError(f"[{name}] the profiled step shows no device time for "
                             "approx_matmul_kernel")

    want_k1 = TRAIN_STEPS_FAMILY * k1_per_train_step(cfg)
    want_calls = collectives_per_train_step(cfg, dp)
    want_bytes = state_bytes_per_rank(cfg, dp)
    dsteps = r0["dp_steps"]
    tag = f"[dp] {cfg.family} dp={dp} {cfg.num_layers} layers"
    row = {"family": cfg.family, "arch": cfg.name, "dp": dp, "layers": cfg.num_layers,
           "world_s": world_s, "seconds_by_rank": [r["seconds"] for r in ranks],
           "losses": [st["loss"] for st in dsteps],
           "one_device_losses": [st["ref_loss"] for st in dsteps],
           "loss_rel_gap": [abs(st["loss"] - st["ref_loss"]) / abs(st["ref_loss"])
                            for st in dsteps],
           "aux": [st["aux"] for st in dsteps],
           "one_device_aux": [st["aux"] for st in out["steps"]],
           "close_by_step": [[st["close"] for st in r["dp_steps"] if "close" in st]
                             for r in ranks],
           "close_by_leaf": [[st["close_by_leaf"] for st in r["dp_steps"] if "close" in st]
                             for r in ranks],
           "send_s": [st["send_s"] for st in out["steps"]],
           "compare_s": [[st["compare_s"] for st in r["dp_steps"] if "close" in st]
                         for r in ranks],
           "host_s_per_step": [[st["host_s"] for st in r["dp_steps"]] for r in ranks],
           "one_device_host_s_per_step": [st["host_s"] for st in out["steps"]],
           "collectives_per_step": want_calls,
           "collective_host_ms_per_step": [[1e3 * st["collective_host_s"]
                                            for st in r["dp_steps"]] for r in ranks],
           "gathered_gb_per_step": [st["gathered_bytes"] / 1e9 for st in dsteps],
           "gathered_gb_counted": gathered_bytes_per_train_step(cfg, dp) / 1e9,
           "k1_launches_per_rank": [r["dp_launches"] for r in ranks],
           "k1_per_step": k1_per_train_step(cfg),
           "state_gb_per_rank": want_bytes / 1e9,
           "whole_state_gb": state_bytes_per_rank(cfg, 1) / 1e9,
           "peak_allocated_gb": [r["peak_allocated_gb"] for r in ranks],
           "peak_reserved_gb": [r["peak_reserved_gb"] for r in ranks]}
    if cfg.family == "moe":                      # per routing call, summed over the ranks
        row["dropped_by_call"] = [[sum(x) for x in zip(*(r["dp_steps"][k]["dropped_by_call"]
                                                         for r in ranks))]
                                  for k in range(len(dsteps))]
        row["one_device_dropped_by_call"] = [st["dropped_by_call"] for st in out["steps"]]
    log(f"{tag}: {json.dumps(row)}")
    for k, st in enumerate(dsteps, 1):
        if not abs(st["loss"] - st["ref_loss"]) <= DP_LOSS_RTOL * abs(st["ref_loss"]):
            raise AssertionError(f"{tag} step {k}: loss {st['loss']}, one device's "
                                 f"{st['ref_loss']} from the same state (rtol {DP_LOSS_RTOL})")
        for rank, r in enumerate(ranks):
            if not r["dp_steps"][k - 1].get("close_ok", True):
                raise AssertionError(f"{tag} step {k}: rank {rank}'s new part is "
                                     f"{r['dp_steps'][k - 1]['close']} from one device's "
                                     "(lr units for the parameters): "
                                     + json.dumps(r["dp_steps"][k - 1]["close_by_leaf"]))
    for rank, r in enumerate(ranks):
        if [st["loss"] for st in r["dp_steps"]] != [st["loss"] for st in dsteps]:
            raise AssertionError(f"{tag}: rank {rank}'s losses are not rank 0's")
        if r["dp_launches"] != want_k1:
            raise AssertionError(f"{tag} rank {rank}: K1 launched {r['dp_launches']}, want "
                                 f"{want_k1} ({TRAIN_STEPS_FAMILY} x k1_per_train_step)")
        calls = [st["collectives"] for st in r["dp_steps"]]
        if calls != [want_calls] * TRAIN_STEPS_FAMILY:
            raise AssertionError(f"{tag} rank {rank}: collectives {calls} per step, want "
                                 f"{want_calls} (collectives_per_train_step)")
        if not r["state_bytes"] == r["state_bytes_after"] == want_bytes:
            raise AssertionError(f"{tag} rank {rank}: state {r['state_bytes']} B, after "
                                 f"{r['state_bytes_after']} B, want {want_bytes}")
    return out, row, {"approx_matmul": sum(r["dp_launches"] for r in ranks),
                      "paged_attention": 0}


def dp_world_gates(name, ranks, cfg, dp, tp, pod):
    """Phase 19's gates of one world, against one device's steps from the
    same states and the counts at its sizes: each step's loss within
    DP_LOSS_RTOL and its new state within ``DpClose``; every rank the same
    losses, DP_STEPS x ``k1_per_train_step`` K1 launches,
    ``collectives_per_train_step`` collectives and
    ``gathered_bytes_per_train_step`` bytes gathered a step,
    ``state_bytes_per_rank`` bytes of state before and after."""
    steps = ranks[0]["steps"]
    want_k1 = DP_STEPS * k1_per_train_step(cfg)
    want_calls = collectives_per_train_step(cfg, dp, tp=tp, pod=pod)
    want_gathered = gathered_bytes_per_train_step(cfg, dp, tp=tp, pod=pod)
    want_bytes = state_bytes_per_rank(cfg, dp, tp=tp, pod=pod)
    for k, st in enumerate(steps, 1):        # against one device from the same state
        if not abs(st["loss"] - st["ref_loss"]) <= DP_LOSS_RTOL * abs(st["ref_loss"]):
            raise AssertionError(f"{name} step {k}: loss {st['loss']}, one device's "
                                 f"{st['ref_loss']} from the same state (rtol {DP_LOSS_RTOL})")
        if not st["close_ok"]:
            raise AssertionError(f"{name} step {k}: the new state is {st['close']} from one "
                                 "device's (lr units for the parameters): "
                                 + json.dumps(st["close_by_leaf"]))
    for rank, r in enumerate(ranks):
        if [st["loss"] for st in r["steps"]] != [st["loss"] for st in steps]:
            raise AssertionError(f"{name}: rank {rank}'s losses are not rank 0's")
        if r["launches"] != want_k1:
            raise AssertionError(f"{name} rank {rank}: K1 launched {r['launches']}, "
                                 f"want {want_k1} ({DP_STEPS} x k1_per_train_step)")
        calls = [st["collectives"] for st in r["steps"]]
        if calls != [want_calls] * DP_STEPS:
            raise AssertionError(f"{name} rank {rank}: collectives {calls} per step, "
                                 f"want {want_calls} (collectives_per_train_step)")
        gathered = [st["gathered_bytes"] for st in r["steps"]]
        if gathered != [want_gathered] * DP_STEPS:
            raise AssertionError(f"{name} rank {rank}: gathered {gathered} B per step, "
                                 f"want {want_gathered} (gathered_bytes_per_train_step)")
        if not r["state_bytes"] == r["state_bytes_after"] == want_bytes:
            raise AssertionError(f"{name} rank {rank}: state {r['state_bytes']} B, "
                                 f"after {r['state_bytes_after']} B, want {want_bytes}")
    return {"losses": [st["loss"] for st in steps],
            "one_device_losses": [st["ref_loss"] for st in steps],
            "loss_rel_gap": [abs(st["loss"] - st["ref_loss"]) / abs(st["ref_loss"])
                             for st in steps],
            "compare_s": [st["compare_s"] for st in steps],
            "close_by_step": [st["close"] for st in steps],
            "close_by_leaf": [st["close_by_leaf"] for st in steps],
            "host_s_per_step": [[st["host_s"] for st in r["steps"]] for r in ranks],
            "one_device_host_s_per_step": [st["ref_host_s"] for st in steps],
            "collectives_per_step": want_calls,
            "collective_host_ms_per_step": [
                [1e3 * st["collective_host_s"] for st in r["steps"]] for r in ranks],
            "gathered_gb_per_step": [st["gathered_bytes"] / 1e9 for st in steps],
            "k1_launches_per_rank": [r["launches"] for r in ranks],
            "k1_per_step": k1_per_train_step(cfg),
            "state_gb_per_rank": want_bytes / 1e9,
            "whole_state_gb": state_bytes_per_rank(cfg, 1) / 1e9,
            "peak_allocated_gb": [r["peak_allocated_gb"] for r in ranks],
            "peak_reserved_gb": [r["peak_reserved_gb"] for r in ranks]}


def dp_block_digests(got, cfg, spec, dev):
    """The digest of each rank's block of the whole state ``got`` (on the
    host) on mesh ``spec``, each block moved to ``dev`` to digest."""
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.parallel import fsdp
    from repro_torch.train.tree import leaves

    shape = parse_mesh(spec, 1)
    dp, tp, pod = dp_mesh_sizes(spec)
    dims = fsdp.split_dims(cfg, shape)
    groups = {"params": leaves(got["params"]), "m": leaves(got["opt"]["m"]),
              "v": leaves(got["opt"]["v"])}
    out = []
    for rank in range(pod * dp * tp):
        d_rank, m_rank = rank // tp % dp, rank % tp        # the model axis fastest

        def cut(t, ds):
            for dim, r, n in ((ds[1], m_rank, tp), (ds[0], d_rank, dp)):
                if dim is not None:
                    t = t.narrow(dim, r * (t.shape[dim] // n), t.shape[dim] // n)
            return t.to(dev)

        part = {g: [cut(t, ds) for t, ds in zip(ts, dims)] for g, ts in groups.items()}
        # the step on ``dev`` too: the digest's weights come from that device's generator
        out.append(state_digest({"params": part["params"],
                                 "opt": {"m": part["m"], "step": got["opt"]["step"].to(dev),
                                         "v": part["v"]}}))
        del part
    return out


def dp_phase(dev, seed, smi):
    """Phase 19 (see the module text)."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.specs import state_specs
    from repro_torch.train import optim as O
    from repro_torch.train.checkpoint import restore_checkpoint
    from repro_torch.train.tree import tree_map

    t_unit = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = dp_config(DP_LAYERS)
    opt = O.OptConfig(lr=3e-4, total_steps=DP_STEPS)          # as launch/train.py
    report = {"worlds": {}, "launches": {}}
    log("[dp] one card, gloo over CUDA tensors: the multi-card NCCL path (launch/train.py "
        "--mesh on N cards) is unchecked here")
    with tempfile.TemporaryDirectory(prefix="dp_") as tmp:
        ckpt_dir = os.path.join(tmp, "ck2")
        meshes = {spec: {"ckpt": ckpt_dir if spec == "2" else None,
                         "restore": ckpt_dir if spec == "2x2" else None} for spec in DP_WORLDS}
        job = {"cfg": cfg, "opt": opt, "seed": seed, "device": str(dev), "meshes": meshes}
        world = max(math.prod(dp_mesh_sizes(spec)) for spec in DP_WORLDS)
        t0 = time.perf_counter()
        every = run_ranks(dp_rank, world, (os.path.join(tmp, "store"), job), timeout=900,
                          rank0_here=True)
        report["world_s"] = time.perf_counter() - t0
        whole = None                   # dp=2's checkpoint restored on one device, on the host
        for spec in ("2",) + tuple(m for m in DP_WORLDS if m != "2"):
            dp, tp, pod = dp_mesh_sizes(spec)
            ranks = [r[spec] for r in every[:dp * tp * pod]]
            name = f"mesh {spec} {DP_LAYERS} layers"
            row = {"mesh": spec, "dp": dp, "tp": tp, "pod": pod, "layers": DP_LAYERS,
                   "mesh_s": ranks[0]["mesh_s"], **dp_world_gates(name, ranks, cfg, dp, tp, pod)}
            if spec == "2":
                # (e) rank 0's checkpoint restored on one device is the ranks'
                # parts joined, bit for bit (each part digested as its rank did)
                t0 = time.perf_counter()
                target = tree_map(lambda t: torch.empty(0), state_specs(cfg, opt))
                whole, at = restore_checkpoint(ckpt_dir, target)
                if at != DP_STEPS or dp_block_digests(whole, cfg, spec, dev) != [
                        r["digest"] for r in ranks]:
                    raise AssertionError(f"{name}: the one-device restore of rank 0's "
                                         f"checkpoint (step {at}) differs from the ranks' parts")
                row.update(ckpt_write_s=ranks[0]["ckpt_s"],
                           ckpt_restore_check_s=time.perf_counter() - t0,
                           ckpt_restores_bit_equal=True)
            if meshes[spec]["restore"]:
                # (d) dp=2's checkpoint restored on this mesh: each rank's blocks
                # are its cut of the one-device restore, bit for bit
                t0 = time.perf_counter()
                if {r["restored_at"] for r in ranks} != {DP_STEPS} or dp_block_digests(
                        whole, cfg, spec, dev) != [r["restored_digest"] for r in ranks]:
                    raise AssertionError(f"{name}: dp=2's checkpoint restored on it differs "
                                         "from its cut of the one-device restore")
                row.update(restore_s=[r["restore_s"] for r in ranks],
                           restore_check_s=time.perf_counter() - t0,
                           restores_dp2_bit_equal=True)
            report["worlds"][name] = row
            report["launches"][f"train_mesh_{spec}"] = {
                "approx_matmul": sum(r["launches"] for r in ranks), "paged_attention": 0}
            log(f"[dp] {name}: {json.dumps(row)}")
    del whole, every
    gc.collect()
    torch.cuda.empty_cache()
    # (a) after the world, in the unit's last and smallest budget
    report["k1_checked"] = len(dp_kernel_checks(cfg, dev, gen))
    base = report["worlds"][f"mesh 2 {DP_LAYERS} layers"]
    for name, row in report["worlds"].items():
        log(f"[dp] {name}: host s per step {row['host_s_per_step'][0]} against dp=2's "
            f"{base['host_s_per_step'][0]} and one device's {row['one_device_host_s_per_step']}; "
            f"{row['collectives_per_step']} collectives a step, host ms "
            f"{row['collective_host_ms_per_step'][0]}; GB gathered {row['gathered_gb_per_step']}; "
            f"state {row['state_gb_per_rank']:.4f} GB a rank; peak reserved "
            f"{row['peak_reserved_gb']} GB ({smi}; gloo on one card)")
    report["seconds"] = time.perf_counter() - t_unit
    log(f"[dp] phase 19 took {report['seconds']:.1f}s (gloo on one card, {smi})")
    return report


# ---------------------------------------------------------------------------
# phase 20: query chunking, a 32,752-token prompt, the fused projections and
# bfloat16 parameters
# ---------------------------------------------------------------------------


_RESERVED = [0]                      # phase 20's largest reserved bytes across its resets


def track_reserved():
    _RESERVED[0] = max(_RESERVED[0], torch.cuda.max_memory_reserved())


def peak_of(fn):
    """(fn's result, the bytes ``max_memory_allocated`` rose above what
    was allocated just before: its temporaries and outputs)."""
    gc.collect()
    torch.cuda.synchronize()
    track_reserved()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def chunk_check(cfg, dev, gen):
    """(a) ``attention_core`` at granite's heads, bf16 q/k/v, one row of
    CHUNK_CHECK_S positions, causal, in chunks of ``cfg.q_chunk`` against
    the whole call: within CHUNK_TOL, each call's temporaries beside the
    prediction (the scores, their float32 softmax and its bf16 copy: 10
    bytes per score, a chunk's 1/8 of the whole)."""
    from repro_torch.models.attention import attention_core

    S, H, Hkv, hd = CHUNK_CHECK_S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = torch.randn((1, S, H, hd), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((1, S, Hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((1, S, Hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    outs, temp = {}, {}
    with torch.no_grad():
        for name, qc in (("whole", S), ("chunked", cfg.q_chunk)):
            outs[name], temp[name] = peak_of(
                lambda: attention_core(q, k, v, causal=True, q_chunk=qc))
    err = (outs["whole"].float() - outs["chunked"].float()).abs().max().item()
    scores = H * S * S
    row = {"S": S, "q_chunk": cfg.q_chunk, "max_abs_err": err,
           "bit_equal": torch.equal(outs["whole"], outs["chunked"]),
           "temp_gb": {k: b / 1e9 for k, b in temp.items()},
           "predicted_temp_gb": {"whole": 10 * scores / 1e9,
                                 "chunked": 10 * scores * cfg.q_chunk / S / 1e9},
           "whole_scores_gb": 4 * scores / 1e9}
    log(f"[levers] (a) chunking: {json.dumps(row)}")
    if not err <= CHUNK_TOL:
        raise AssertionError(f"attention_core in chunks of {cfg.q_chunk} is {err} from the "
                             f"whole call (tolerance {CHUNK_TOL})")
    return row


def k1_rows_check(a, b, cfg, rows=256):
    """K1 at a full (M, K) x (K, N) against its plain version on the first,
    a middle and the last ``rows`` rows (the plain version of the whole
    would take tens of GB): the kernel's offsets at M x N near 2**31."""
    from repro_torch.kernels.approx_matmul import approx_matmul, approx_matmul_plain

    M = a.shape[0]
    out = approx_matmul(a, b, multiplier=cfg.approx.multiplier)
    for r0 in (0, M // 2, M - rows):
        ref = approx_matmul_plain(a[r0:r0 + rows], b, multiplier=cfg.approx.multiplier)
        if not torch.equal(out[r0:r0 + rows], ref):
            raise AssertionError(f"K1 M={M} K={a.shape[1]} N={b.shape[1]}: rows "
                                 f"{r0}-{r0 + rows} differ from the plain version")
    return (M, a.shape[1], b.shape[1])


def admission_costs(cfg):
    """The dry run's count (``launch/dryrun.in_depth`` on meta) of one
    paged admission of one LEVER_MAX_LEN-token row, as ``ServeSession``
    runs it: the fused prefill (``forward(return_kv=True)``), the row's
    logits at its last prompt position, the K/V scattered into an f32 pool
    of one row's blocks."""
    from repro_torch.launch.dryrun import in_depth
    from repro_torch.launch.roofline import count_costs
    from repro_torch.launch.specs import params_specs
    from repro_torch.models.transformer import forward, init_paged_cache
    from repro_torch.serve.cache import scatter_prompt_blocks

    W = LEVER_MAX_LEN // BLOCK_SIZE

    def count(c):
        def admit(params, cache, prompts, lens, seat):
            logits, kvs = forward(c, params, prompts, return_kv=True)
            last = logits[torch.arange(prompts.shape[0], device=prompts.device), lens - 1]
            scatter_prompt_blocks(cache, kvs, seat, BLOCK_SIZE)
            return last

        meta = torch.device("meta")
        i32 = lambda *shape: torch.empty(shape, dtype=torch.int32, device=meta)
        return count_costs(admit, params_specs(c, frozen=True),
                           init_paged_cache(c, W, BLOCK_SIZE, device=meta),
                           i32(1, LEVER_MAX_LEN), i32(1), i32(1, W))
    # the admission holds every layer's K/V until it scatters them
    return in_depth(cfg, count, peak="grows")["total"]


def long_prompt(cfg, params, dev, seed, gen):
    """(b) One LEVER_PROMPT-token request of LEVER_NEW greedy tokens at full
    width through K1 and K2 (paged, f32 pool, max_len LEVER_MAX_LEN: 2,048
    blocks a row), against the same session through the gather (its
    admission replayed from the K2 run's); the K2 session's admission held
    to the dry run's count of its temporaries."""
    import repro_torch.serve.scheduler as S
    from repro_torch.kernels.approx_matmul import approx_matmul
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.models.transformer import forward
    from repro_torch.serve import ServeSession

    rng = np.random.default_rng(seed + 20)
    prompt = rng.integers(0, cfg.vocab_size, LEVER_PROMPT).astype(np.int32)
    W = LEVER_MAX_LEN // BLOCK_SIZE
    out = {"prompt": LEVER_PROMPT, "new": LEVER_NEW, "max_len": LEVER_MAX_LEN, "blocks": W,
           "q_chunk": cfg.q_chunk,
           "unchunked_scores_gb_per_layer": 4 * cfg.num_heads * LEVER_MAX_LEN ** 2 / 1e9}
    # K1 at the head's prefill shape (M x N = 1.63e9 outputs) and K2 at W
    a = torch.randint(0, 256, (LEVER_MAX_LEN, cfg.d_model), generator=gen, device=dev,
                      dtype=torch.uint8)
    out["k1_checked"] = [k1_rows_check(a, params["lm_head"].codes, cfg)]
    del a
    k2rng = np.random.default_rng(seed + 21)
    k2 = [k2_check(f"W={W}", paged_case(k2rng, dev, 1, W, BLOCK_SIZE, cfg.num_kv_heads,
                                        cfg.num_heads // cfg.num_kv_heads, cfg.head_dim,
                                        pool_dtype=dt), BLOCK_SIZE)
          for dt in K2_POOLS.values()]
    out["k2_max_abs_err"] = max(e for e, _ in k2)
    out["k2_max_abs_err_bf16_q"] = max(e for _, e in k2)
    counted = admission_costs(cfg)

    def session(attn, replay=None):
        """One session on the prompt; with ``replay`` (the K2 run's pool,
        admission blocks and first token) its admission writes that pool
        in place of a second prefill of the same prompt: the prefill does
        not attend through K2, so the two runs' prefills are one forward,
        bit for bit (phase 5), and only decode attention differs."""
        gc.collect()
        torch.cuda.empty_cache()
        sess = ServeSession(cfg, params, num_slots=1, max_len=LEVER_MAX_LEN,
                            prompt_buckets=(LEVER_MAX_LEN,), block_size=BLOCK_SIZE,
                            policy="fifo", attn_impl=attn, seed=seed, loop="sync", device=dev)
        sess.submit(prompt, max_new=LEVER_NEW, req_id=0)
        seen, prefill, fwd = {}, sess._prefill, S.forward

        def last_row(*a, **kw):               # the prompt's last logits, for the report
            logits, kvs = fwd(*a, **kw)
            seen["last"] = logits[0, LEVER_PROMPT - 1].clone()
            return logits, kvs

        def admit(c, prompts, lens, req_ids, seat):
            out_ = []
            seen["admission"] = peak_of(lambda: out_.append(prefill(c, prompts, lens, req_ids,
                                                                    seat)))[1]
            seen["seat"], seen["first"] = np.array(seat), out_[0].clone()
            track_reserved()
            return out_[0]

        def replayed(c, prompts, lens, req_ids, seat):
            if not np.array_equal(np.asarray(seat), replay["seat"]):
                raise AssertionError("the replayed admission's blocks are not the K2 run's")
            for name in ("k", "v"):
                sess.cache[name].copy_(replay.pop(name))
            return replay["first"].clone()
        sess._prefill = admit if replay is None else replayed
        S.forward = last_row
        approx_matmul.launches = paged_attention.launches = 0
        t0 = time.perf_counter()
        try:
            res = sess.run()
        finally:
            S.forward = fwd
        torch.cuda.synchronize()
        st = sess.stats
        row = {"tokens": res[0].tokens.tolist(), "wall_s": time.perf_counter() - t0,
               "ttft_s": st.ttft_s_p50, "ticks": st.ticks, "admit_calls": st.admit_calls,
               "table_width": sess.table_width, "num_blocks": sess.num_blocks,
               "launches": {"approx_matmul": approx_matmul.launches,
                            "paged_attention": paged_attention.launches},
               "replayed_admission": replay is not None}
        if replay is None:
            row.update(admission_temp_gb=seen["admission"] / 1e9,
                       admission_peak_gb=(seen["admission"] + torch.cuda.memory_allocated()) / 1e9,
                       last_logits_finite=bool(torch.isfinite(seen["last"]).all()),
                       last_argmax=int(seen["last"][:cfg.vocab_size].argmax()))
            seen.update(sess.cache)
        del sess
        track_reserved()
        return row, seen

    k2run, seen = session("kernel")
    gather, _ = session("gather", replay={k: seen[k] for k in ("seat", "first", "k", "v")})
    del seen
    runs = {"kernel": k2run, "gather": gather}
    out.update(counted_temp_gb=counted.peak_bytes / 1e9,
               measured_temp_gb=k2run["admission_temp_gb"])
    rel, slack = TEMP_TOL
    temp = k2run["admission_temp_gb"] * 1e9
    if not abs(counted.peak_bytes - temp) <= rel * temp + slack:
        raise AssertionError(f"the {LEVER_MAX_LEN}-token admission's temporaries: counted "
                             f"{counted.peak_bytes} B, measured {temp} B")
    for attn, r in runs.items():
        passes = r["ticks"] + (0 if r["replayed_admission"] else r["admit_calls"])
        want = {"approx_matmul": k1_per_pass(cfg) * passes,
                "paged_attention": cfg.num_layers * r["ticks"] if attn == "kernel" else 0}
        if r["launches"] != want:
            raise AssertionError(f"long prompt ({attn}): launches {r['launches']}, want {want}")
        if r["table_width"] != W or len(r["tokens"]) != LEVER_NEW:
            raise AssertionError(f"long prompt ({attn}): {len(r['tokens'])} tokens over "
                                 f"{r['table_width']} blocks")
    if not k2run["last_logits_finite"] or k2run["last_argmax"] != k2run["tokens"][0]:
        raise AssertionError(f"long prompt: the prompt's last logits (finite: "
                             f"{k2run['last_logits_finite']}) do not pick its first token")
    got, want = runs["kernel"]["tokens"], runs["gather"]["tokens"]
    out["tie"] = None
    if got != want:                       # the near-tie rule, in forward
        j = next(i for i, (x, y) in enumerate(zip(got, want)) if x != y)
        seq = np.zeros((1, LEVER_MAX_LEN), np.int32)
        n = LEVER_PROMPT + j
        seq[0, :n] = np.concatenate([prompt, np.asarray(want[:j], np.int32)])
        with torch.no_grad():       # padded to the chunked length: causal, so row n - 1 holds
            lg = forward(cfg, params, torch.as_tensor(seq, device=dev))[0, n - 1]
        gap = (lg[want[j]] - lg[got[j]]).item()
        out["tie"] = {"new_token_index": j, "tokens": [got[j], want[j]], "logit_gap": gap}
        if abs(gap) > NEAR_TIE:
            raise AssertionError(f"long prompt: K2 {got} vs gather {want}, no near tie "
                                 f"(logit gap {gap})")
    out["runs"] = runs
    log(f"[levers] (b) long prompt: {json.dumps(out)}")
    return out


def k1_fused_checks(cfg, dev, gen):
    """(c) K1 bit-equal to its plain version at the fused (K, N) of
    granite (q/k/v and gate/up) and at their per-rank parts at tp 2 and
    4, at M = NUM_SLOTS and one admission's rows."""
    from repro_torch.kernels.approx_matmul import approx_matmul, approx_matmul_plain

    d, hd = cfg.d_model, cfg.head_dim
    qkv, gu = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd, 2 * cfg.d_ff
    shapes = sorted({(d, n // tp) for n in (qkv, gu) for tp in (1,) + TP_DEGREES})
    checked = []
    for K, N in shapes:
        for M in (NUM_SLOTS, NUM_SLOTS * BUCKETS[-1]):
            a = torch.randint(0, 256, (M, K), generator=gen, device=dev, dtype=torch.uint8)
            b = torch.randint(0, 256, (K, N), generator=gen, device=dev, dtype=torch.uint8)
            out = approx_matmul(a, b, multiplier=cfg.approx.multiplier)
            ref = approx_matmul_plain(a, b, multiplier=cfg.approx.multiplier)
            if out.dtype != torch.int32 or not torch.equal(out, ref):
                raise AssertionError(f"K1 fused M={M} K={K} N={N}: "
                                     f"{int((out != ref).sum())} outputs differ")
            checked.append((M, K, N))
    log(f"[levers] (c) K1 bit-equal at the fused shapes {checked}")
    return checked


def fused_serving(cfg, params, dev, seed, trace, phase4):
    """(c) Phase 4's first FUSED_REQUESTS requests through a session with
    ``fuse_qkv`` and ``fuse_gate_up`` and through one without, on the
    same frozen weights: the fused tokens equal phase 4's, K1's launches
    per pass ``k1_per_pass`` of the fused config; host ms per decode tick
    of both (recorded, not gated)."""
    from repro_torch.kernels.approx_matmul import approx_matmul
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.models.transformer import fuse_params
    from repro_torch.serve import ServeSession

    fcfg = dataclasses.replace(cfg, fuse_qkv=True, fuse_gate_up=True)
    fparams = fuse_params(fcfg, params)
    leaf_bytes = {k: sum(t.nbytes for t in fparams["layers"][blk][k])
                  for blk, k in (("attn", "wqkv"), ("ffn", "w_gate_up"))}
    rows = {}
    for name, c, p in (("unfused", cfg, params), ("fused", fcfg, fparams)):
        sess = ServeSession(c, p, num_slots=NUM_SLOTS, max_len=MAX_LEN, prompt_buckets=BUCKETS,
                            block_size=BLOCK_SIZE, policy="fifo", attn_impl="kernel",
                            seed=seed, loop="sync", device=dev)
        for i, (pr, n, a) in enumerate(trace[:FUSED_REQUESTS]):
            sess.submit(pr, max_new=n, arrival=a, req_id=i)
        ticks, inner = [], sess.step

        def step():
            admits = sess.stats.admit_calls
            t0 = time.perf_counter()
            r = inner()
            torch.cuda.synchronize()
            if sess.stats.admit_calls == admits:
                ticks.append(1e3 * (time.perf_counter() - t0))
            return r
        sess.step = step
        approx_matmul.launches = paged_attention.launches = 0
        res = sess.run()
        st = sess.stats
        passes = st.ticks + st.admit_calls
        rows[name] = {"tokens": {rid: r.tokens.tolist() for rid, r in res.items()},
                      "k1_launches": approx_matmul.launches,
                      "k2_launches": paged_attention.launches, "passes": passes,
                      "k1_per_pass": approx_matmul.launches / passes,
                      "k1_per_pass_predicted": k1_per_pass(c),
                      "decode_tick_host_ms_median": float(np.median(ticks)) if ticks else None,
                      "decode_ticks_timed": len(ticks)}
        del sess
    for name, r in rows.items():
        if r["k2_launches"] <= 0:
            raise AssertionError(f"{name}: K2 was never launched")
        if r["k1_launches"] != r["k1_per_pass_predicted"] * r["passes"]:
            raise AssertionError(f"{name}: K1 launched {r['k1_launches']} in {r['passes']} "
                                 f"passes, want {r['k1_per_pass_predicted']} per pass")
        for rid, toks in r["tokens"].items():
            if toks != phase4["results"][rid][0]:
                raise AssertionError(f"{name} request {rid}: {toks}, phase 4 served "
                                     f"{phase4['results'][rid][0]}")
    out = {"sessions": rows, "fused_leaf_gb": {k: b / 1e9 for k, b in leaf_bytes.items()}}
    log(f"[levers] (c) fused serving: {json.dumps(out)}")
    del fparams
    return out


def bf16_training(dev, seed):
    """(d) One QAT step at full width, ORACLE_LAYERS deep, with
    ``param_dtype="bfloat16"``, ``fuse_qkv`` and ``fuse_gate_up``: through
    K1, again, and through its plain version from identical state,
    bit-identical (``train_oracle``); the parameter bytes and peak of one
    such step beside the float32, unfused one; the dry run's bytes a dp=2
    step at ORACLE_LAYERS gathers, in each dtype."""
    from repro_torch.data.synthetic import token_batches
    from repro_torch.launch.dryrun import gathered_bytes_per_train_step
    from repro_torch.launch.specs import params_specs
    from repro_torch.parallel.sharding import tree_bytes
    from repro_torch.train import optim as O
    from repro_torch.train.loop import as_batch

    f32 = train_config(ARCH, ORACLE_LAYERS)
    bf16 = dataclasses.replace(f32, param_dtype="bfloat16", fuse_qkv=True, fuse_gate_up=True)
    opt = O.OptConfig(lr=3e-4, total_steps=TRAIN_STEPS)          # as launch/train.py
    batch = as_batch(next(token_batches(f32.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=seed)), dev)
    out = {"layers": ORACLE_LAYERS}
    for name, c in (("float32", f32), ("bfloat16", bf16)):
        t0 = time.perf_counter()
        (loss, _, _, k1), peak = peak_of(lambda: one_step(c, opt, seed + 1, batch, dev))
        if k1 != k1_per_train_step(c):
            raise AssertionError(f"the {name} step launched K1 {k1} times, want "
                                 f"{k1_per_train_step(c)} (k1_per_train_step)")
        out[name] = {"loss": loss, "k1_launches": k1, "k1_predicted": k1_per_train_step(c),
                     "param_gb": tree_bytes(params_specs(c)) / 1e9,
                     "peak_gb": peak / 1e9, "s": time.perf_counter() - t0,
                     "dp2_gathered_gb": gathered_bytes_per_train_step(c, DP) / 1e9}
    out["oracle"] = train_oracle(bf16, opt, seed, batch, dev, "levers")
    if not math.isfinite(out["bfloat16"]["loss"]):
        raise AssertionError(f"the bf16-parameter step's loss is {out['bfloat16']['loss']}")
    log(f"[levers] (d) bf16 parameters: {json.dumps(out)}")
    return out


def levers_phase(dev, seed, trace, phase4, smi):
    """Phase 20 (see the module text)."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import freeze_params

    t_unit = time.perf_counter()
    cfg = serving_configs()[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    report = {"chunking": chunk_check(cfg, dev, gen), "launches": {}, "seconds_by_part": {}}
    t0 = time.perf_counter()
    report["k1_fused_checked"] = k1_fused_checks(cfg, dev, gen)
    params = freeze_params(cfg, init_params(cfg, seed=seed, device=dev))
    report["fused"] = fused_serving(cfg, params, dev, seed, trace, phase4)
    report["seconds_by_part"]["fused"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    del params                          # (b) runs LEVER_LAYERS deep: a cut of depth
    lcfg = dataclasses.replace(cfg, num_layers=LEVER_LAYERS)
    params = init_params(lcfg, seed=seed, device=dev, freeze=True)
    report["long"] = long_prompt(lcfg, params, dev, seed, gen)
    report["seconds_by_part"]["long"] = time.perf_counter() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report["bf16"] = bf16_training(dev, seed)
    report["seconds_by_part"]["bf16"] = time.perf_counter() - t0
    fused = report["fused"]["sessions"]["fused"]
    report["launches"] = {
        "long_prompt": report["long"]["runs"]["kernel"]["launches"],
        "long_prompt_gather": report["long"]["runs"]["gather"]["launches"],
        "fused": {"approx_matmul": fused["k1_launches"],
                  "paged_attention": fused["k2_launches"]},
        "train_bf16": {"approx_matmul": report["bf16"]["bfloat16"]["k1_launches"],
                       "paged_attention": 0}}
    track_reserved()
    report["peak_reserved_gb"] = _RESERVED[0] / 1e9
    report["seconds"] = time.perf_counter() - t_unit
    log(f"[levers] phase 20 took {report['seconds']:.1f}s, reserved at most "
        f"{report['peak_reserved_gb']:.2f} GB ({smi})")
    return report


# ---------------------------------------------------------------------------
# phases 8-15's units, run by a pool of processes on the one card
# ---------------------------------------------------------------------------


def serving_configs():
    """Phase 4's config (approx, per-row activation scales) and its oracle's
    (K1's plain version, ``approx_lowrank``)."""
    from repro_torch.configs import get_config
    from repro_torch.serve import resolve_execution_mode

    cfg = get_config(ARCH)
    return (dataclasses.replace(cfg, approx=resolve_execution_mode("approx", act_per_row=True)),
            dataclasses.replace(cfg, approx=resolve_execution_mode("approx_lowrank",
                                                                   act_per_row=True)))


def _slots_unit(dev, sh):
    cfg, ocfg = serving_configs()
    return slots_phase(cfg, ocfg, dev, sh["seed"], sh["trace"], sh["paged_tokens"], sh["smi"],
                       sh["profile_paged"], sh["profile"])


def _async_unit(dev, sh):
    return async_phase(serving_configs()[0], dev, sh["seed"], sh["trace"], sh["phase4"],
                       sh["smi"], sh["profile_paged"], sh["profile"])


def _share_unit(dev, sh):
    # phase 11 runs FEATURE_LAYERS deep (a cut of depth, not width)
    fcfg = dataclasses.replace(serving_configs()[0], num_layers=FEATURE_LAYERS)
    return share_phase(fcfg, dev, sh["seed"], sh["trace"], sh["smi"])


def _chunked_unit(runs):
    return lambda dev, sh: chunked_phase(serving_configs()[0], dev, sh["seed"], sh["trace"],
                                         sh["smi"], runs)


def _family_unit(arch):
    return lambda dev, sh: family_phase(arch, dev, sh["seed"], sh["smi"], sh["profile"])


def _train_unit(arch):
    return lambda dev, sh: train_family_phase(arch, dev, sh["seed"])


def _backbone_unit(arch):
    return lambda dev, sh: backbone_phase(arch, dev, sh["seed"])


# each unit with the card memory (GB) it reserves at its peak, or a tuple
# of them, one for each stretch of the unit (``next_budget``), all
# measured on one H100 (reserved; PERF.md section 6): a granite unit
# builds the model's f32 weights (20.0 GB with their freezing), then
# serves on the frozen ones (slots 7.7, async 3.8, chunked 5.4, its sync
# run 3.5); the qwen2-moe-a2.7b unit holds its frozen model, then a
# 4-layer f32 one, and frees each before phase 18's ranks load it; a
# training unit of phase 14 or 15 takes its one-device steps in its own
# process, as rank 0 of phase 19 (b)'s dp=2 world (qwen2-moe-a2.7b 31.5
# GB at 1 layer, falcon-mamba-7b 22.1 at 2, zamba2-2.7b 11.4, qwen2-vl-2b
# 14.0 with its serving parts, musicgen-large 3.5), then the two ranks'
# parts (22.8 + 23.8, 18.3 + 17.4, 7.8 + 7.5, 12.7 + 12.8, 2.7 + 2.7),
# then its 4-layer oracle (the one-device steps' peak again); phase 19's
# rank 0 runs in its unit's process too, and its world of 4 ranks runs one
# mesh a stretch (the ranks' peaks summed, plus a CUDA context a process:
# 13.0 + 3 x 7.7 at 2x1x2, 12.3 + 7.0 at dp=2, 11.5 + 6.5 + 6.1 + 6.5 at
# 2x2), then rank 0's checks and (a)'s K1 checks alone (11.6: the plain
# version at qwen2-moe's 152,064-column head);
# phase 20's 34.1 (the long prompt's admission at 20 layers: the frozen
# model, a 2,048-block f32 pool and 29.1 GB of temporaries; see PERF.md).
# They start in this order whenever the budgets still to come of the units
# running leave room.  The pool is bound by memory held over time; the
# order is the one that finished soonest on average when the measured
# seconds, with noise of -20% to +25%, and these budgets were fed to a
# simulation of ``run_units``
UNITS = {
    "share": (6, _share_unit),
    FAMILY_ARCHS[2]: (6, _family_unit(FAMILY_ARCHS[2])),
    f"train {FAMILY_ARCHS[0]}": ((32, 48, 32), _train_unit(FAMILY_ARCHS[0])),
    f"train {FAMILY_ARCHS[2]}": ((12, 16, 12), _train_unit(FAMILY_ARCHS[2])),
    BACKBONE_ARCHS[0]: ((15, 26, 15), _backbone_unit(BACKBONE_ARCHS[0])),
    "chunked": ((22, 7), _chunked_unit(("async", f"chunk_{CHUNK_SMALL}"))),
    FAMILY_ARCHS[0]: (25, _family_unit(FAMILY_ARCHS[0])),
    f"train {FAMILY_ARCHS[1]}": ((23, 37, 23), _train_unit(FAMILY_ARCHS[1])),
    "dp": ((40, 22, 34, 13), lambda dev, sh: dp_phase(dev, sh["seed"], sh["smi"])),
    "tp": (10, lambda dev, sh: tp_phase(dev, sh["seed"], sh["trace"], sh["smi"])),
    "chunked_sync": ((22, 5), _chunked_unit(("sync",))),
    FAMILY_ARCHS[1]: (16, _family_unit(FAMILY_ARCHS[1])),
    "tiers": (7, lambda dev, sh: tiers_phase(serving_configs()[0], dev, sh["seed"],
                                             sh["trace"], sh["smi"])),
    BACKBONE_ARCHS[1]: ((4, 6, 4), _backbone_unit(BACKBONE_ARCHS[1])),
    "slots": ((22, 9), _slots_unit),
    "paper": (22, lambda dev, sh: paper_phase(dev, sh["seed"])),
    "async": ((22, 5), _async_unit),
    "levers": (35, lambda dev, sh: levers_phase(dev, sh["seed"], sh["trace"], sh["phase4"],
                                                sh["smi"])),
}
POOL_GB = 72                         # the units' peaks at once: the card's 85 GB less headroom


def _watch_parent(parent):
    """End this worker when the process that started it is gone."""
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(3)


def _worker_init(parent):
    from repro_torch.kernels._build import build_all

    threading.Thread(target=_watch_parent, args=(parent,), daemon=True).start()
    torch.set_num_threads(2)                    # the pool's workers share the host's cores
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_all()                                 # loads the parent's libraries


def budgets(name):
    """The GB a unit of UNITS holds in each of its stretches, in turn."""
    gb = UNITS[name][0]
    return gb if isinstance(gb, tuple) else (gb,)


def next_budget():
    """Move this pool unit to the next stretch of its ``budgets`` (the
    last one stays): the allocator's cached blocks are released, the peak
    reserved since the last move is kept beside the budget it was held
    to, and the pool is told, so that it may start units in the room the
    unit's later stretches leave.  Outside the pool it does nothing."""
    if _POOL is None:
        return
    name, results = _POOL
    gc.collect()
    torch.cuda.empty_cache()
    seq = budgets(name)
    _SEGMENTS.append({"budget_gb": seq[min(len(_SEGMENTS), len(seq) - 1)],
                      "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9})
    torch.cuda.reset_peak_memory_stats()
    results.put(("budget", name))


def run_unit(name, shared):
    """One unit in a pool worker: (name, its report or None, the traceback
    of its failure or None, its log lines, its seconds and peak memory, by
    stretch of its ``budgets``)."""
    global _UNIT_LOG
    _UNIT_LOG = []
    t0 = time.perf_counter()
    try:
        out, err = UNITS[name][1](torch.device("cuda", 0), shared), None
    except Exception:
        out, err = None, traceback.format_exc()
    seq = budgets(name)
    segments = _SEGMENTS + [{"budget_gb": seq[min(len(_SEGMENTS), len(seq) - 1)],
                             "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9}]
    meta = {"seconds": time.perf_counter() - t0,
            "peak_reserved_gb": max(x["peak_reserved_gb"] for x in segments),
            "segments": segments}
    return "done", name, out, err, _UNIT_LOG, meta


def _unit_process(name, shared, parent, results):
    global _POOL
    _worker_init(parent)
    _POOL = (name, results)
    results.put(run_unit(name, shared))


def run_units(shared):
    """Every unit of UNITS, at most POOL_WORKERS at a time, each in a fresh
    process: {name: (report, meta)}.  Each running unit keeps the largest
    of its ``budgets`` still to come (so a stretch never waits for room);
    a unit starts, in UNITS' order, when its largest budget fits in what
    the others keep, within POOL_GB.  The first failure stops the others
    and raises."""
    done = {}
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[pool] this process reserves {torch.cuda.memory_reserved() / 1e9:.2f} GB")
    # reserved memory near what is allocated, so that a unit stays near its peak
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    todo, running, stretch = list(UNITS), {}, {}

    def kept(name):
        return max(budgets(name)[stretch.get(name, 0):])

    try:
        while todo or running:
            for name in list(todo):
                if len(running) < POOL_WORKERS and \
                        sum(kept(n) for n in running) + kept(name) <= POOL_GB:
                    stretch[name] = 0
                    proc = running[name] = ctx.Process(
                        target=_unit_process, args=(name, shared, os.getpid(), results),
                        name=f"chip_smoke-{name}")
                    proc.start()
                    todo.remove(name)
            try:
                msg = results.get(timeout=1.0)
            except queue.Empty:
                dead = [n for n, proc in running.items() if proc.exitcode is not None]
                if not dead:
                    continue
                try:                            # a report may still be on its way
                    msg = results.get(timeout=30.0)
                except queue.Empty:
                    raise AssertionError(f"unit {dead[0]} ended (exit code "
                                         f"{running[dead[0]].exitcode}) without a report")
            if msg[0] == "budget":
                stretch[msg[1]] = min(stretch[msg[1]] + 1, len(budgets(msg[1])) - 1)
                continue
            _, name, out, err, lines, meta = msg
            running.pop(name).join()
            for line in lines:
                log(line)
            log(f"[pool] {name}: {json.dumps(meta)}")
            if err is not None:
                raise AssertionError(f"unit {name} failed:\n{err}")
            done[name] = (out, meta)
    finally:
        for proc in running.values():
            proc.terminate()
            proc.join()
    return done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the full report here (JSON)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile a few steady decode ticks (see profile_decode)")
    args = ap.parse_args(argv)
    t_main = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} missing; run from a checkout",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.approx_matmul import approx_matmul
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.models.transformer import forward, init_params
    from repro_torch.serve import freeze_params

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32/f64
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    report = {}

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build_s = build_all()
    report["build_s"] = {"per_source": build_s, "total": time.perf_counter() - t0}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    report["card"] = smi
    log(f"[build] {json.dumps(report['build_s'])}")
    log(smi)

    cfg, ocfg = serving_configs()
    t0 = time.perf_counter()
    params = freeze_params(cfg, init_params(cfg, seed=args.seed, device=dev))
    torch.cuda.synchronize()
    log(f"[setup] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size} -> {cfg.padded_vocab}; init + freeze "
        f"{time.perf_counter() - t0:.1f}s")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    warm_up(dev)

    # -- 2. K1 ---------------------------------------------------------------
    k1_shapes, k1_checked, k1_step, k1_train = k1_phase(cfg, params, gen, dev,
                                                        NUM_SLOTS * BUCKETS[-1])
    k1_err = max(r["max_abs_err"] for r in k1_checked)
    report["k1"] = {"shapes": k1_shapes, "checked": len(k1_checked), "max_abs_err": k1_err,
                    "decode_step": k1_step, "train_step": k1_train}

    # -- 3. K2 ---------------------------------------------------------------
    (k2_err, k2_err16), k2_steps, k2_long = k2_phase(cfg, dev, args.seed)
    k2_step = k2_steps["f32"]
    report["k2"] = {"max_abs_err": k2_err, "max_abs_err_bf16_q": k2_err16,
                    "decode_step": k2_steps, "long_context": k2_long}

    # -- 4. serve ------------------------------------------------------------
    rng = np.random.default_rng(args.seed)
    trace = make_trace(rng, cfg.vocab_size, REQUESTS)
    serve(cfg, params, trace[:1], dev, "kernel", args.seed, loop="sync")   # warm-up
    approx_matmul.launches = paged_attention.launches = 0
    sess, results, wall = serve(cfg, params, trace, dev, "kernel", args.seed, loop="sync")
    launches = {"approx_matmul": approx_matmul.launches,
                "paged_attention": paged_attention.launches}
    st = sess.stats
    generated = sum(len(r.tokens) for r in results.values())
    served = {"requests": len(results), "generated_tokens": generated, "wall_s": wall,
              "tok_per_s": generated / wall, "ttft_p50_s": st.ttft_s_p50,
              "ttft_p50_ticks": st.ttft_p50, "ticks": st.ticks,
              "peak_blocks_in_use": st.peak_blocks_in_use, "num_blocks": sess.num_blocks,
              "prefills": {str(k): v for k, v in st.prefills.items()},
              "admit_calls": st.admit_calls, "launches": launches,
              "host_block_s": st.host_block_s, "overlap_fraction": st.overlap_fraction,
              "launches_per_request": {k: v / len(results) for k, v in launches.items()}}
    report["serve"] = served
    log(f"[serve] {json.dumps(served)}")
    if len(results) != len(trace):
        raise AssertionError(f"served {len(results)} of {len(trace)} requests")
    for rid, r in results.items():
        if r.tokens.shape != (trace[rid][1],) or not (
                (r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all():
            raise AssertionError(f"request {rid}: bad tokens {r.tokens.tolist()}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the served path")

    # -- 5. oracle -----------------------------------------------------------
    osess, oracle, owall = serve(ocfg, params, trace[:2], dev, "gather", args.seed)
    if (approx_matmul.launches, paged_attention.launches) != tuple(launches.values()):
        raise AssertionError("the oracle session launched a kernel")
    for rid in (0, 1):
        got, want = results[rid].tokens.tolist(), oracle[rid].tokens.tolist()
        log(f"[oracle] request {rid}: kernels {got}")
        log(f"[oracle] request {rid}: plain   {want}")
        if got != want:
            raise AssertionError(f"request {rid}: greedy tokens differ from the plain oracle")
    # K1 is exact, so a prefill (K1 only; no decode attention) through the
    # kernel and through the plain versions gives bit-identical logits
    with torch.no_grad():
        prompts = np.zeros((2, BUCKETS[-1]), np.int32)
        for i in (0, 1):
            prompts[i, :trace[i][0].size] = trace[i][0]
        toks = torch.as_tensor(prompts, device=dev)
        same_prefill = torch.equal(forward(cfg, params, toks), forward(ocfg, params, toks))
    if not same_prefill:
        raise AssertionError("prefill logits through K1 differ from the plain version's")
    decode_diff = [decode_step_diff(cfg, params, trace, toks, dev, dt) for dt in K2_POOLS.values()]
    for d in decode_diff:
        log(f"[oracle] one decode step, K2 vs its plain version: {json.dumps(d)}")
    distinct = len({t for r in results.values() for t in r.tokens.tolist()})
    log(f"[oracle] prefill logits bit-identical; {distinct} distinct tokens served")
    report["oracle"] = {"requests": 2, "identical": True, "prefill_logits_identical": True,
                        "decode_step": decode_diff, "distinct_served_tokens": distinct,
                        "wall_s": owall}
    if args.profile:
        report["profile"] = profile_decode(cfg, params, trace, dev, args.seed)
        log(f"[profile] {json.dumps(report['profile'])}")

    paged_tokens = {rid: r.tokens.tolist() for rid, r in results.items()}
    phase4 = {"ticks": st.ticks, "results": {rid: (r.tokens.tolist(), r.admitted_tick,
                                                   r.finished_tick)
                                             for rid, r in results.items()}}

    # -- 16. granite's prefill and decode steps, counted and run ----------
    report["roofline"] = {"granite": roofline_serve(cfg, params, trace, dev)}

    # -- 10 (e). the stall probe, on phase 4's weights, alone on the card ---
    stall, stall_s = stall_check(cfg, params, trace, dev, args.seed, smi)

    # -- 6. K3 ---------------------------------------------------------------
    report["k3"] = k3_phase(dev, gen)

    # -- 7. train ------------------------------------------------------------
    # free the serving weights, sessions and pools first: full-width f32
    # params, grads and Adam moments take about 42 GB of the card's 80
    del params, sess, osess, results, oracle, toks
    gc.collect()
    torch.cuda.empty_cache()
    report["train"] = train_phase(dev, args.seed)
    train = report["train"]

    # -- 8 (a) and 13 (a)'s K2: timed for the kernels line, alone on the card
    k1_cnn = k1_cnn_shapes(dev, gen, args.seed)
    moe_k2 = family_k2(get_config(FAMILY_ARCHS[0]), dev, args.seed)

    # -- 8-15: the units, on a pool of processes -----------------------------
    t_pool = time.perf_counter()
    shared = {"seed": args.seed, "trace": trace, "paged_tokens": paged_tokens,
              "phase4": phase4, "smi": smi, "profile_paged": report.get("profile"),
              "profile": args.profile}
    units = run_units(shared)
    unit = {name: out for name, (out, _) in units.items()}
    report["pool"] = {"workers": POOL_WORKERS, "wall_s": time.perf_counter() - t_pool,
                      "units": {name: meta for name, (_, meta) in units.items()}}
    log(f"[pool] {len(units)} units on {POOL_WORKERS} processes: "
        f"{report['pool']['wall_s']:.1f}s")

    paper = report["paper"] = {"k1": k1_cnn, **unit["paper"]}
    log(f"[paper] phase 8 took {paper['seconds']:.1f}s (K1 at the CNN shapes apart)")
    slots = report["slots"] = unit["slots"]
    log(f"[slots] phase 9 took {slots['seconds']:.1f}s")
    asy = report["async"] = unit["async"]
    asy["stall_probe"] = stall
    asy["seconds_by_part"]["stall_probe"] = stall_s
    log(f"[async] phase 10 took {asy['seconds']:.1f}s, its stall probe {stall_s:.1f}s")
    report["share"] = unit["share"]
    share = report["share"]["launches"]
    log(f"[share] phase 11 took {report['share']['seconds']:.1f}s: "
        f"{json.dumps(report['share']['seconds_by_part'])}; launches by path "
        f"{json.dumps(share)}, by run {json.dumps(report['share']['launches_by_run'])}")

    # phase 12: (a)-(b), (c) and (c)'s sync run, held to its async run here
    t12 = report["tiers"] = unit["tiers"]
    chunked, chunked_sync = unit["chunked"], unit["chunked_sync"]
    chunked_sync_gate(chunked_sync["tokens"]["sync"], chunked["tokens"]["async"])
    t12["chunked"] = {**chunked["chunked"], "sync": chunked_sync["chunked"]["sync"]}
    for part, u in (("chunked", chunked), ("chunked_sync", chunked_sync)):
        t12["seconds_by_part"][part] = u["seconds"]
        t12["seconds"] += u["seconds"]
        t12["launches_by_run"].update(u["launches_by_run"])
        for path, n in u["launches"].items():
            tally = t12["launches"].setdefault(path, dict.fromkeys(n, 0))
            for k, v in n.items():
                tally[k] += v
    tiers = t12["launches"]
    log(f"[tiers] phase 12 took {t12['seconds']:.1f}s: "
        f"{json.dumps(t12['seconds_by_part'])}; launches by path "
        f"{json.dumps(tiers)}, by run {json.dumps(t12['launches_by_run'])}")
    # phases 11 and 12 count each feature path's sessions
    paths = {**share, **tiers}

    # -- 13. families --------------------------------------------------------
    families = {arch: unit[arch] for arch in FAMILY_ARCHS}
    ep = families[FAMILY_ARCHS[0]].pop("ep")            # phase 18 ran in this unit
    families[FAMILY_ARCHS[0]]["k2"] = moe_k2
    report["families"] = {**families, "seconds": sum(f["seconds"] for f in families.values())}
    fam = {f["family"]: f["launches"] for f in families.values()}
    log(f"[families] phase 13 took {report['families']['seconds']:.1f}s: "
        + json.dumps({a: f["seconds_by_part"] for a, f in families.items()})
        + f"; launches by path {json.dumps(fam)}")
    paths.update(fam)

    # -- 14. training of the families; 15. the vlm and audio backbones -------
    tf = report["train_families"] = {arch: unit[f"train {arch}"] for arch in FAMILY_ARCHS}
    bb = report["backbones"] = {arch: unit[arch] for arch in BACKBONE_ARCHS}
    for arch, r in tf.items():
        paths[f"train_{r['family']}"] = {"approx_matmul": r["launches"], "paged_attention": 0}
        paths[f"train_{r['family']}_dp2"] = r["dp_launches"]
    for arch, b in bb.items():
        paths[b["family"]] = b["launches"]
        paths[f"train_{b['family']}"] = {"approx_matmul": b["train"]["launches"],
                                         "paged_attention": 0}
        paths[f"train_{b['family']}_dp2"] = b["train"]["dp_launches"]
    log(f"[train families] phase 14 took "
        f"{sum(r['seconds'] for r in tf.values()):.1f}s; [backbones] phase 15 took "
        f"{sum(b['seconds'] for b in bb.values()):.1f}s; launches by path "
        + json.dumps({k: v for k, v in paths.items() if k.startswith("train_")
                      or k in ("vlm", "audio")}))

    # -- 17. tensor-parallel serving ----------------------------------------
    tp = report["tp"] = unit["tp"]
    paths.update(tp["launches"])
    log(f"[tp] phase 17 took {tp['seconds']:.1f}s; launches by path "
        f"{json.dumps(tp['launches'])}")

    # -- 18. MoE expert parallelism ------------------------------------------
    report["ep"] = ep
    paths.update(ep["launches"])
    log(f"[ep] phase 18 took {ep['seconds']:.1f}s; launches by path "
        f"{json.dumps(ep['launches'])}")

    # -- 19. data-parallel FSDP training -------------------------------------
    dpr = report["dp"] = unit["dp"]
    paths.update(dpr["launches"])
    dpr["families"] = {r["family"]: r["dp"] for r in tf.values()}
    dpr["families"].update({b["family"]: b["train"]["dp"] for b in bb.values()})
    log(f"[dp] phase 19 took {dpr['seconds']:.1f}s; launches by path "
        f"{json.dumps(dpr['launches'])}")

    # -- 20. query chunking, a long prompt, fused projections, bf16 params ---
    lev = report["levers"] = unit["levers"]
    paths.update(lev["launches"])
    lev["train_float32_phase7"] = {"peak_gb": train.get("peak_gb"),
                                   "oracle": train.get("oracle")}
    log(f"[levers] phase 20 took {lev['seconds']:.1f}s: {json.dumps(lev['seconds_by_part'])}; "
        f"launches by path {json.dumps(lev['launches'])}")

    # -- 16. roofline ---------------------------------------------------------
    roof = report["roofline"]
    roof["granite"]["train"] = train["roofline"]
    for step_name, r in roof["granite"].items():
        log(f"[roofline] phase 16 {step_name}: device {r['device_ms']:.4g} ms, events "
            f"{r['events_ms']:.4g} ms, host {r['host_ms']:.4g} ms; bound {r['bound_ms']:.4g} ms "
            f"({r['bound_by']}; compute {r['t_compute_ms']:.4g}, memory "
            f"{r['t_memory_ms']:.4g}) = {r['bound_share']:.4f} of the device time; model-FLOP "
            f"share {r['model_flop_share']:.5f}; temp predicted {r['predicted_temp_gb']:.4g} GB, "
            f"measured {r['measured_temp_gb']:.4g} GB (peak {r['max_memory_allocated_gb']:.4g} "
            f"GB); launches {json.dumps(r['launches'])}")
    for step_name in ("decode", "prefill", "train"):
        paths[f"roofline_{step_name}"] = roof["granite"][step_name]["launches"]
    log(smi)

    k3 = report["k3"]
    kernels = [
        {"name": "approx_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/approx_matmul.cu",
         "replaces": "src/repro/kernels/approx_matmul/kernel.py:85",
         "launches": launches["approx_matmul"] + train["launches"]
         + paper["k1_launches_table_viii"] + slots["k1_launches"]
         + asy["launches"]["approx_matmul"] + asy["verify"]["k1_launches"]
         + sum(n["approx_matmul"] for n in paths.values()),
         "launches_by_path": {"serve": launches["approx_matmul"], "train": train["launches"],
                              "table_viii": paper["k1_launches_table_viii"],
                              "slots": slots["k1_launches"],
                              "async": asy["launches"]["approx_matmul"],
                              "verify": asy["verify"]["k1_launches"],
                              **{path: n["approx_matmul"] for path, n in paths.items()},
                              "table_viii_by_net": {f"{r['net']}-{r['dataset']}": r["k1_launches"]
                                                    for r in paper["table_viii"]}},
         "max_abs_err": max(k1_err, paper["k1"]["max_abs_err"]),
         "ms": k1_step["ms"], "plain_ms": k1_step["plain_ms"],
         "bound_ms": k1_step["bound_ms"], "bound_by": k1_step["bound_by"],
         "library_ms": None,
         "per": f"decode step: {k1_step['calls']} calls at M={NUM_SLOTS}",
         "decode_step": {k: k1_step[k] for k in ("calls", "M", "ms", "device_ms", "plain_ms",
                                                 "bound_ms", "bound_by")},
         "train_step": {"calls": k1_train["calls"], "M": k1_train["M"],
                        "device_ms": train["profiled_step"]["k1_device_ms"],
                        "events_ms": k1_train["events_ms"], "plain_ms": k1_train["plain_ms"],
                        "bound_ms": k1_train["bound_ms"], "bound_by": k1_train["bound_by"]},
         "resnet19_forward": {
             **paper["k1"]["resnet19_forward"],
             "qat_step_device_ms": paper["resnet19"]["profiled_step"].get("k1_device_ms"),
             "launches_per_forward": paper["resnet19"]["k1_launches_per_forward"]}},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:141",
         "launches": launches["paged_attention"] + asy["launches"]["paged_attention"]
         + sum(n["paged_attention"] for n in paths.values()),
         "launches_by_path": {"serve": launches["paged_attention"],
                              "async": asy["launches"]["paged_attention"],
                              **{path: n["paged_attention"] for path, n in paths.items()}},
         "max_abs_err": max(k2_err, moe_k2["max_abs_err"], lev["long"]["k2_max_abs_err"],
                            *(b["k2_check"]["max_abs_err"] for b in bb.values()),
                            *(r["max_abs_err"] for r in tp["k2"] + ep["k2"])),
         "max_abs_err_bf16_q": max(k2_err16, moe_k2["max_abs_err_bf16_q"],
                                   lev["long"]["k2_max_abs_err_bf16_q"],
                                   *(b["k2_check"]["max_abs_err_bf16_q"] for b in bb.values()),
                                   *(r["max_abs_err_bf16_q"] for r in tp["k2"] + ep["k2"])),
         "max_abs_err_served_bf16_q": max(b["decode"]["k2_max_abs_err"] for b in bb.values()),
         "ms": k2_step["ms"], "plain_ms": k2_step["plain_ms"],
         "bound_ms": k2_step["bound_ms"], "bound_by": k2_step["bound_by"],
         "library_ms": k2_step["library_ms"], "device_ms": k2_step["device_ms"],
         "per": f"decode step: {k2_step['calls']} calls at B={NUM_SLOTS}, f32 pool, bf16 q",
         "bf16_pool_decode_step": {k: k2_steps["bf16"][k] for k in (
             "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "long_context_per_call": {pool: {k: row.get(k + "_per_call") for k in (
             "ms", "device_ms", "plain_ms", "bound_ms", "library_ms")}
             for pool, row in k2_long.items()},
         "moe_decode_step": {pool: {k: row[k] for k in (
             "calls", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
             for pool, row in moe_k2["decode_step"].items()}},
        {"name": "approx_mul_eltwise", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/approx_mul_eltwise.cu",
         "replaces": "src/repro/kernels/approx_mul_eltwise/kernel.py:34",
         "launches": k3["launches"], "max_abs_err": k3["max_abs_err"],
         "ms": k3["timed"]["ms"], "plain_ms": k3["timed"]["plain_ms"],
         "bound_ms": k3["timed"]["bound_ms"], "bound_by": k3["timed"]["bound_by"],
         "library_ms": None,
         "per": f"one call of {k3['timed']['n']} elements"},
    ]
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_main
    log(f"[done] the run took {report['seconds']:.1f}s, its pool {report['pool']['wall_s']:.1f}s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
