"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — the card's name and power limit (``nvidia-smi``);
2. build — the four CUDA libraries compiled for ``sm_90a`` from
   ``src/repro_torch``, one ``nvcc`` each, in parallel, with the registers,
   static shared memory and spills of each tensor-core kernel and of each
   instance of ``gmm``'s fp32 tiled body from the compiler's report
   (``-Xptxas -v``);
2b. swiglu_add — the §6.1 SwiGLU + Add path: both modes against their plain
   versions at M in {256, 1000, 4096, 32768} and F in {2048, 36} (ragged
   rows, an unaligned row width), bf16 and fp32; then
   ``launch.bench_swiglu_add.main`` on the card: the port's simulator rows
   (a prediction of the Ascend A3 model, printed as a line of their own)
   and both modes checked and timed at the paper's h [M, 4096],
   y [M, 2048], M in {8192, 16384, 32768}, beside the H100 bytes bound.
   Launches: 2 per serial call, 1 per interleaved call;
3. kernel checks — each kernel against its plain PyTorch version on the card,
   at the serving path's shapes (granite-moe-3b-a800m: 48 experts, C = 1 and
   2 in decode, 27 in a 128-token prefill), at the training shape (C = 854:
   4096 tokens x top-8 / 48 experts x 1.25; GMM2's backward reads its
   operands as transposed views, as ``gmm_trainable`` passes them), at every
   tile edge of the tensor-core kernels (C in TILE_EDGES) and at ragged test
   shapes, in bf16 and fp32. Each bf16 path and tile-edge call is made twice
   and must be bit-equal. Timed rows give the device time (``ms``: CUDA
   graph replay) beside the eager time of the same calls (``eager_ms``),
   the host's time to issue one call (``host_us``), the plain version's, the
   ``torch.bmm`` yardstick's (``library_ms`` for gmm; ``gemm_only_ms``, the
   [E, C, 2F] product alone, for gmm_swiglu) and the bytes/operations bound.
   The training shape also checks ``moe_expert_ffn(trainable=True)``'s three
   grads against the plain versions of its backward's steps, fed its own
   bf16 intermediates, and end to end against autograd through the plain
   FFN by each grad's relative error norm. ``gmm_swiglu_bwd`` is held
   elementwise on its fp32 outputs at the training shape, at every C in
   TILE_EDGES and at ragged shapes; each call is made twice and must be
   bit-equal, its bf16 outputs (the main path's call) must be its fp32
   outputs rounded, and its row names the body that ran: the training
   shape must run the tensor-core body. Its timed row gives the main path's
   call, the fp32-output call, and the three ``torch.bmm`` products of the
   same sizes (``gemm_only_ms``). Then the EP paths' shapes
   (``ep_kernel_rows``, phase 14 (a)): granite's at ep = 4 (12 experts a
   rank, a ring chunk's C_pair = 688 rows and a baseline call's 2,752,
   forward and backward, the backward on its tensor-core body) and the
   paper module's (E = 8, K = 7168, F = 2048 at C = 2,560 and 10,240),
   each timed by device time only beside its bound and ``torch.bmm``
   (the backward beside the three ``torch.bmm`` of its sizes); phase 19's
   (``dist_kernel_rows``: 24 experts a rank at ep = 2 and a ring chunk's
   C_pair = 2,736 of a rank's 4,096 tokens, ``dist_capacity``;
   gmm_swiglu, gmm and its dx and dW calls, and the backward on its
   tensor-core body, each twice and bit-equal, untimed); and dbrx-132b's
   shapes (phase 16 (d) and (e): E = 16, K = 6144, F = 10752
   at a decode step's C = 3, a 128-token prefill's C = 40 and a
   4096-token training step's C = 1,280; at the last also gmm as GMM2's
   two backward calls and the backward kernel on its tensor-core body),
   twice and bit-equal, timed the same way;
4. slice — full-width, 32-layer granite-moe-3b-a800m in bf16 with random
   weights from a seed: one prefill through the kernels against the plain
   expert FFN, then ``launch.serve.serve`` answers 16 requests of 128-token
   prompts with 8 slots and 32 new tokens each. Both forward kernels' launch
   counts must equal 32 x (prefills + decode steps);
5. train_parity — the same model cut to 2 layers (full width): loss and
   grads of one 4096-token batch through the kernels against the plain
   expert FFN, on the same params;
6. train — ``launch.train`` at full width and depth: AdamW steps on
   ``SyntheticStream`` batches of 1 x 4096 tokens (the repo's train_4k
   sequence; its global batch of 256 cut to 1 for one card), per-layer
   remat. Finite losses and grad norms; per layer per step, with remat,
   gmm_swiglu 2 launches (forward, recompute), gmm 4 (forward, recompute,
   dx and dw of the backward) and gmm_swiglu_bwd 1, every one of those on
   its tensor-core body. Then the step's time split into each kernel's
   time x launches and the rest;
7. dropless_tiles — ``gmm`` against its plain version at the calls the
   dropless fragment's tiles make: E = 1, fp32, ragged rows C in
   DROPLESS_ROWS, GMM1 (K/N = 1536/1024) and GMM2 (512/1536), their
   activation-gradient products with w a transposed view, and their weight
   gradients with x a transposed view (a reduction over the rows); then the
   fp32 bodies' edges (DROPLESS_EDGES: ragged C, K and N, E = 3, all four
   layouts, the narrow body's and the calls TMA cannot describe);
   repeat calls bit-equal. Each row names its body (``gmm.fp32_body``):
   every tile call must run the tiled body from ``first_tiled`` rows of
   its own on (``gmm.tiled_takes``: the tiled body's grid fills the card,
   or ``gmm.FP32_TILED_MIN_ROWS``) and the narrow body below, and the tiled
   and narrow bodies' launch counts must grow by one for each row that
   names them.
   The six calls at C = DROPLESS_TIMED_ROWS are timed. Then
   ``row_count_bits``: at E = 1 and both GMM widths, the rows of
   ``gmm(x[:, :C], w)`` for C = 1 ... ROW_BITS_MAX (the narrow body, then
   the tiled body up to ``gmm.FP32_TILED_MIN_ROWS`` + 8) must be bit-equal
   to the rows of the C = ROW_BITS_MAX call;
8. dropless_fragment — ``launch.bench_dropless`` on one full-width layer
   (T = 4096, the layer's own router, seed 0) at ep = 1 and ep = 4 (four
   virtual ranks on the card; their puts are device copies, not a
   collective): the forward against the plain executor and against the
   fixed-capacity ``moe_grouped`` with a capacity that drops nothing, the
   grads against autograd of the plain fragment, the backward's recompute
   bit-equal to the forward; then the fragment's forward (a cache hit) and
   backward ms, compile ms on a miss, tasks and ``gmm`` launches per call,
   beside the fixed-capacity bf16 layer's forward and backward (C = 854);
9. dropless_train — a 2-layer full-width dropless step against the
   fixed-capacity step at a capacity that drops nothing (loss within
   LOSS_TOL, each grad leaf's norm within GNORM_TOL); then
   ``launch.train --dropless`` at full width and depth, DROPLESS_STEPS
   steps of 1 x 4096 tokens (the first is warm-up): per step ms, tokens/s,
   the ``ssc_*`` counters, peak memory and ``gmm`` launches, the only
   kernel that path runs, with those of its fp32 tiled body (at least one).
   Remat runs each fragment's forward once, so every step makes 2 x 32 SSC
   lookups, all misses (``check_dropless_lookups``); the step ms, peak and
   lookups of the whole-block checkpoint are printed beside them;
10. fused_dropless — ``launch.bench_fused_dropless``: K = 2 full-width
   layers (each its own router and experts, seed 0) on T = 4096 tokens as
   one fused taskflow with LayerBoundary tiles, at ep = 1 and 4: the fused
   block's output and every grad bit-equal to its sequential twin's,
   within 1e-5 of the plain executor (y elementwise, each grad by its
   relative error norm), its blobs of 2 fragments; then both timed,
   called alternately (forward and backward ms, busy ms, compile ms on a
   miss, ``gmm`` launches) beside ``select_fused``'s verdict (a
   prediction of the Ascend A3 model);
11. pp_fused — ``core.fusion.compile_pp_fused`` with S = 2 stages and
   M = 2 microbatches at ep = 4 and granite's widths, each stage on a plan
   routed from PP_TOKENS tokens by its own router: the StageBoundary
   taskflow through the executor, forward and backward, with the
   rank-local stage maps the reference's PP tests use, bit-equal to the
   cells run one by one;
12. elastic — ``DroplessMoE(ep=4).rescale(dead_ranks=[1, 3])``: the ep = 2
   handle shares the re-keyed cache, and its output and grads equal a
   natively built ep = 2 handle's; a routed ep = 4 plan remapped by
   ``core.elastic.remap_plan`` runs through the executor on the
   re-chunked weights, and the survivors' ``y_ret`` equals the ep = 4
   run's bit for bit (every GMM tile there has at least 16 rows, so it
   runs the tiled body, one ascending-k chain an output); the compile ms
   of that plan after ``rekey_for_mesh``.

13. serve_online — self-tuning serving: one full-width layer's dropless
   fragment on a decode-sized batch (8 tokens x top-8, ep = 4) bit-equal
   under ``exact``, ``linear:4`` and the ladder fitted on the decode
   population, each within 1e-5 of the plain executor
   (``fragment_bits_case``); the model cut to 2 full-width layers serving
   8 requests through ``OnlineMoE`` with the same greedy tokens whether or
   not ``swap_to("linear:4")`` is forced at decode step 2
   (``forced_swap_case``); the first prefill through ``OnlineMoE`` within
   LOGIT_TOL x max|logit| of the plain FFN at a capacity that drops
   nothing (``online_prefill_case``); then ``launch.serve.main`` at full
   width and depth, 16 requests of 128-token prompts, 8 slots,
   ONLINE_MAX_NEW new tokens, ``--sched auto --online-refit``,
   ``--slo-us`` the predicted step at SLO_SLOTS busy slots and
   ``--max-queue`` ONLINE_QUEUE: every
   request finishes or is reported shed (the first four offers are), no
   non-finite logit, and only fp32 ``gmm`` launches (by body: small-row,
   tiled), beside phase 4's fixed-capacity numbers. Its µs are the Ascend
   A3 cost model's predictions, not H100 times.

14. ep — expert parallelism on ep = 4 virtual ranks (mesh 1 x 4; each
   collective a device copy), the MoE's expert FFN through the kernels:
   (b) ``ep_parity``: granite at full width cut to 2 layers, one
   4096-token step through ``make_train_step(mesh=, ep=EPConfig(mode,
   capacity_factor=4.0))`` in each mode, the kernels against the plain
   FFN within phase 5's limits, and the modes against each other (bit
   equality reported); (c) ``ep_train``: ``launch.train --mesh 1x4
   --ep-mode hyperparallel`` then ``baseline`` at full width and depth,
   EP_STEPS steps of 1 x 4096 tokens: finite losses, step ms, tokens/s,
   peak memory, collectives and bytes a rank, and per layer per step 2F
   ``gmm_swiglu``, 4F ``gmm`` and F ``gmm_swiglu_bwd`` launches (F = 16
   FFN calls a ring forward, 4 a baseline one), every one on its
   tensor-core body; (d) ``ep_modes``: ``launch.bench_ep_modes --full``
   (the paper's module, 8192 tokens a rank, bf16), each mode within 2e-2
   of the output's scale of its plain FFN, its forward launches F, its
   forward and forward + backward ms and bytes a rank; (e)
   ``ep_flash_decode``: ``make_flash_decode`` at the serving cell's
   decode shape against ``decode_attention`` on the written cache, and
   ``ep_nccl``: a one-rank NCCL group running ``make_moe_ep`` on
   ``DistComm`` in both modes, y and grads bit-equal to ``VirtualComm``.

15. ft — checkpoint and fault tolerance, under
   ``torch.use_deterministic_algorithms(True)``: (a) granite at full width
   cut to PARITY_LAYERS layers, the fixed-capacity ``make_train_step`` on
   ``SyntheticStream`` batches of 1 x 4096 tokens through
   ``ft.runner.train_loop`` with checkpoints in the JAX package's layout
   (``convert.JaxTrainLayout``) under ``tempfile.mkdtemp()`` (removed
   after; the phase raises if the disk cannot hold two checkpoints): an
   uninterrupted FT_STEPS-step run saving every FT_EVERY steps and keeping
   FT_KEEP, then a run killed by ``inject_fault`` before step FT_CRASH and
   its resume from step FT_EVERY; the resumed (step, loss, grad_norm) log
   and the final params and optimizer state must equal the uninterrupted
   run's bit for bit (``torch.equal`` on every leaf). The resume restores
   in place: the device memory it adds over the fresh state it fills,
   read from ``torch.cuda.max_memory_allocated`` before the first resumed
   step, must stay within one leaf. It prints the checkpoint's bytes (from
   its manifest), that peak, each save's and restore's seconds and GB/s
   (host copy, CRC and the disk of the card's machine: not a device rate),
   and the kernels' launches (2, 4 and 1 a layer a step, every one on its
   tensor-core body);
   (b) ``ft.harness`` on the card: all six (kind, profile) cells, every
   check true, launching ``gmm`` and no other kernel.

16. families — the dense, ssm and hybrid families and dbrx-132b, each
   arch's memory freed before the next and its peak read after
   ``torch.cuda.reset_peak_memory_stats()``: (a) path consistency at full
   width in fp32, cut in depth (FAMILY_CONSISTENCY: 2 layers, 5 for
   recurrentgemma-2b, one super-block and its tail): the prefill's last
   logits and teacher-forced decode steps within FAMILY_TOL x max|logit|
   of the forward on the same tokens, recurrentgemma's 2,100-token prompt
   past its 2,048-token window so that its ring wraps (gated), mamba2's
   lengths those its SSD chunk accepts; (b) llama3_2-3b, mamba2-1_3b and
   recurrentgemma-2b at full width and depth in bf16 serving phase 4's
   traffic through ``launch.serve.serve``: every request its MAX_NEW
   tokens, no non-finite logit, no kernel launch (their matmuls are
   cuBLAS); prefill and decode step ms, tokens/s, peak memory; (c) the
   same three through ``launch.train.main --arch`` for FAMILY_TRAIN_STEPS
   steps of 1 x TRAIN_SEQ tokens: finite losses and grad norms, no kernel
   launch, step ms, peak memory; (d) dbrx-132b at full width cut from 40
   layers to DBRX_LAYERS (bf16, ~15 GB): one 128-token prefill through the
   kernels within LOGIT_TOL x max|logit| of the plain expert FFN, then
   DBRX_REQUESTS requests served, ``gmm_swiglu`` and ``gmm`` launching
   DBRX_LAYERS x (prefills + decode steps) times each, the path
   ``families`` of the ``kernels`` line; (e) the same 2 layers' training
   step on one 1 x TRAIN_SEQ batch (loss and grads, without the AdamW
   update, whose fp32 state does not fit one card) through the kernels,
   launching TRAIN_LAUNCHES x DBRX_LAYERS times (the path
   ``families_train``, every backward on the tensor cores), and through
   the plain expert FFN: loss within LOSS_TOL, every grad leaf's norm
   within GNORM_TOL, as phase 5.

17. audio_vlm — the audio and vlm families and the dry run: (a) at full
   width cut to AV_LAYERS layers in fp32, internvl2-26b's prefill over its
   256 patches + 128 tokens and VLM_STEPS teacher-forced decode steps
   within FAMILY_TOL x max|logit| of the forward on the same patches (the
   logits without patches must differ by more), and hubert-xlarge's
   encoder on the card within AUDIO_TOL x max|logit| of the same forward
   on the CPU, a change to its last frame moving its first frame's logits;
   (b) at full depth in bf16, internvl2-26b serving phase 4's traffic on
   tokens alone through ``launch.serve.serve``, then ``prefill_step`` on
   PATCH_BATCH x (256 patches + 128 tokens), and hubert-xlarge's
   ``prefill_step`` (its encoder forward) on 1 x 32,768 frames (prefill_32k
   with its batch of 32 cut to 1): medians, tokens/s, peak memory, no
   kernel launch (path ``audio_vlm``); (c) FAMILY_TRAIN_STEPS training
   steps (bf16, fp32 AdamW) of hubert-xlarge at full depth on 1 x 4,096
   frames and of internvl2-26b cut to VLM_TRAIN_LAYERS layers on 1 x 4,096
   tokens with its patches: finite losses and grad norms, no kernel launch
   (path ``audio_vlm_train``); (d) ``launch.dryrun`` over all 31 arch x
   shape cells on the meta device in DRYRUN_WORKERS processes, started
   after phase 6 with phase 21 (b)'s and run while the card works on
   phases 7-16 (``BackgroundCounts``): 0 failures, every train and
   prefill cell's FLOPs at least ``model_flops`` less the products no step
   makes (``dryrun.lookup_flops``), and each run of (b) and (c) counted at
   its own batch and depth, its share of the roofline (max(t_compute,
   t_memory) over its measured time) at most SHARE_MAX, its counted peak
   beside ``torch.cuda.max_memory_allocated()``.

18. tools — the one-card tools: ``launch.hillclimb``, the examples. (b)
   On the card, each hill-climb variant's real step
   (``hillclimb.variant_steps``, mesh TOOLS_MESH of virtual ranks): first
   llama3.2-3b's decode at full depth on a DECODE_BATCH x 32,768-slot
   cache of random keys and values (decode_32k, batch cut from 128), one
   warm-up and DECODE_STEPS teacher-forced steps, ``baseline`` (flash
   decoding over the ranks) and ``flashdecode_off`` (the dense one-token
   attention), and the two paths in fp32 at PARITY_LAYERS layers within
   FAMILY_TOL x max|logit| of each other (their bf16 full-depth gap is
   printed, not gated); then, beside (a), granite's train_4k at full
   width cut to TOOLS_LAYERS layers and batch 1 under GRANITE_VARIANTS
   and hubert-xlarge's at TOOLS_LAYERS layers, TOOLS_STEPS steps each (the
   first warm-up). Each run beside its count at the same cut: measured ms
   (median after warm-up), ``t_compute``, ``t_memory``, ``t_collective``,
   collectives and bytes a rank, and its share of the roofline. Gates:
   counted collectives and bytes equal the run's; every share at most
   SHARE_MAX; finite losses, grad norms and logits; granite's GMM
   launches 2F ``gmm_swiglu``, 4F ``gmm`` and F ``gmm_swiglu_bwd`` a
   layer a step (F, 3F and F without the MoE's recompute: remat off or
   policy "save_moe"), all on the tensor cores, and none elsewhere;
   ``baseline`` and ``zero1`` bit-equal first losses; the two EP modes'
   first loss and grad norm within LOSS_TOL and GNORM_TOL. (a) The
   hill-climb's three cells at the reference's global batches under
   TOOLS_CELL_VARIANTS, and each run of (b) at its cut, counted on the
   meta device in TOOLS_WORKERS spawned processes: no failure, and every
   variant of the MoE cell counts collectives. (c) The four examples
   through their ``main`` on the card (``quickstart``,
   ``schedule_explorer`` dumping under ``tempfile``, ``serve_decode`` on
   its default arch and on granite's smoke config, ``train_moe_e2e`` for
   E2E_STEPS steps with checkpoints under ``tempfile``): each returns; the
   MoE ones launch the GMM kernels, the others none. Its paths in the
   ``kernels`` line: ``tools_hillclimb``, ``tools_quickstart``,
   ``tools_serve_decode``, ``tools_train_moe_e2e``.

19. dist_train — training across processes: ``launch.train --nproc
   DIST_PROCS --backend gloo --n-layers DIST_LAYERS`` on the one card (NCCL refuses two ranks on
   one card, so the ranks' collectives go through host buffers over gloo:
   this measures a shared card, not links or scaling), granite at full
   width cut to DIST_LAYERS layers, mesh DIST_MESH, bf16, DIST_STEPS steps
   of DIST_BATCH x TRAIN_SEQ tokens, zero1 then ep_dp (the MoE on the
   ring over each model row). Gates: step 1's loss within LOSS_TOL and each
   grad leaf's norm within GNORM_TOL of the one-process run over virtual
   ranks at the same mesh (``dist_virtual_case``); finite losses and grad
   norms; each process's ``gmm_swiglu`` / ``gmm`` / ``gmm_swiglu_bwd``
   launches DIST_LAYERS x 2 ring steps x (2, 4, 1) a step, all on tensor
   cores; each process's optimizer-state bytes those of its
   ``opt_state_spec`` blocks; ep_dp's checkpoint, written by rank 0 in the
   reference's layout, restored here, every rank's block of every leaf
   equal (CRC32) to the block that rank ended with. Printed: each mode's
   median step ms, collectives and bytes a rank a step, peak memory a
   process, and NCCL's refusal of two ranks on the one card. The path
   ``dist_train`` of the ``kernels`` line sums the processes' launches.
   Each mode also prints rank 0's host seconds a step in each kind of
   transfer (``comm.stats.seconds``), the rest of its step being compute
   and waits for the other ranks.

19b. dist_dropless — dropless training across processes: ``launch.train
   --nproc DIST_PROCS --backend gloo --dropless`` on the one card in each
   of DROPLESS_DIST_MODES (ep_dp, the reference README's, then tp_sp, the
   reference's default), granite at full width cut to DIST_LAYERS layers,
   mesh DIST_MESH, bf16 with fp32 AdamW, remat, DIST_STEPS steps of
   DIST_BATCH x DROPLESS_DIST_SEQ tokens (4,096, phase 8's fragment and
   phase 9's parity step), ``DroplessConfig(ep = the model axis)``: every
   process gathers the whole batch and every expert and runs the whole
   fragment (``launch.dropless.MeshRows``). Gates: step 0's loss within
   LOSS_TOL and each grad leaf's norm within GNORM_TOL of the one-process
   dropless step on the same global batch and params
   (``dist_dropless_case``); finite losses and grad norms; every process
   2 x DIST_LAYERS SSC lookups a step, all misses on step 0; each
   process's ``gmm`` launches a step, all on the fp32 bodies (tiled,
   small-row), equal every other process's, FRAGMENT_GMM_PER_EXPERT a
   routed expert a layer, and no other kernel (``dist_dropless_check``;
   the one-process step's printed beside: a bf16 near tie may route a
   rarely chosen expert otherwise); params and optimizer state
   the bytes of their spec blocks. Printed: step ms, collectives, bytes
   and ``comm_s_per_step`` a rank by kind, peaks, each process's
   ``ssc_*`` counters. Both modes run in one spawn of the processes
   (``train.main_runs``), as phase 19's two runs and phase 20 (a)'s two
   do. The path ``dist_dropless`` of the ``kernels`` line sums the
   processes' launches.

20. dist_tp — tp_sp across processes: phase 19's setup (``launch.train
   --nproc DIST_PROCS --backend gloo --n-layers DIST_LAYERS``, granite at
   full width cut to DIST_LAYERS layers, mesh DIST_MESH, bf16 with fp32
   AdamW, DIST_STEPS steps of DIST_BATCH x TRAIN_SEQ tokens) in mode
   tp_sp, then tp_sp with ``fsdp=True`` (``train.main(fsdp=True)``): the
   heads, the vocabulary, the experts and the residual's sequence split
   over ``model``, with FSDP the attention and expert matrices' ``d`` over
   ``data`` too (``parallel.tp``). Gates as phase 19's: step 1's loss
   within LOSS_TOL and each assembled grad leaf's norm within GNORM_TOL of
   the one-process tp_sp run over virtual ranks; finite losses; each
   process's params and optimizer state the bytes of its spec blocks;
   phase 19's launches, all on tensor cores; rank 0's checkpoint (the
   FSDP run's) restoring every rank's blocks. Printed: the step medians,
   the collectives and bytes a rank a step by kind, ``comm_s_per_step``
   and each process's peak. (b) The other families in tp_sp
   (``run_dist_families``): DIST_FAMILIES at full width cut in depth
   (gemma-2b, mamba2-1.3b, recurrentgemma-2b at one super-block and its
   2-layer tail, internvl2-26b with FSDP and its 256 patches a row,
   hubert-xlarge on frames), one spawn of DIST_PROCS processes for all,
   DIST_FAMILY_STEPS steps each of ``make_steps(mode="tp_sp")`` on each
   rank's block of the batch (``sharding.batch_block``). Gates: step 0's
   loss within LOSS_TOL and each reduced grad leaf's norm within GNORM_TOL
   of a one-process bf16 run over the data groups (mamba2's ``A_log`` to
   the size of its grad's terms); finite losses; params and optimizer
   state the bytes of their spec blocks; no kernel launch. Printed beside
   them: the step times, collectives, bytes and ``comm_s_per_step`` a rank,
   peaks allocated and reserved (the processes' allocators grow segments
   in place), this process's and the card's memory before the spawn, and
   the one-process bf16 run's own gap from an fp32 run (mamba2's alone,
   DIST_FP32_ARCHS). (c) Serving across the processes, in the same spawn
   after the trainings (``serve_ranks``): each SERVE_LAYOUTS layout (granite
   with EP through ``gmm_swiglu``/``gmm`` in tp_sp on DIST_BATCH rows and in
   zero1 and ep_dp on SERVE_REPEAT_ROWS, the families in tp_sp) runs
   ``make_steps(...).prefill_step`` of SERVE_PROMPT tokens a row
   (recurrentgemma 2,048, so that its decode wraps the ring) into each
   rank's ``cache_spec`` blocks, then SERVE_NEW teacher-forced
   ``decode_step``s (flash decoding over the slot blocks). Gates: every
   rank's prefill and decode logits within LOGIT_TOL x max|logit| of the
   one-process bf16 run over virtual ranks on the same params and tokens
   (``serve_yardsticks``, made before the spawn); finite logits; each
   process's cache bytes those of its ``cache_spec`` blocks after the
   prefill and after the last step; granite's launches a process
   ``serve_launches_per_process``, all on tensor cores, none for the other
   families. Printed: the prefill's ms and the decode step's median ms,
   collectives and bytes a rank of the prefill and of a decode step,
   ``comm_s_per_step``, each process's peak and each layout's seconds. The
   path ``dist_tp`` of the ``kernels`` line sums the processes' launches;
   the line also has the whole script's seconds so far.

21. dryrun_meshes — the dry run on the reference's production meshes
   (``launch.dryrun``, rank 0's program on a counting process mesh, the
   meta device, no card). (a) Phase 20's two tp_sp runs (DIST_TP_RUNS:
   granite at DIST_LAYERS layers, DIST_BATCH x TRAIN_SEQ tokens, mesh
   DIST_MESH) counted on ``launch.mesh.counting_mesh(DIST_MESH)``: the
   forward's collectives by kind and the bytes a rank sends must equal
   those phase 20's processes recorded on the card for a step; beside
   them every transfer of the step, the backward's included; phase 20
   (c)'s granite tp_sp prefill and one decode step the same way. (b)
   PROD_CELLS (every arch's train_4k in tp_sp on 16x16, granite and dbrx in
   zero1 and ep_dp on 16x16 and 2x16x16) and PROD_SERVE_CELLS (eight
   serving cells in tp_sp on 16x16) counted in the DRYRUN_WORKERS
   processes of phase 17 (d)'s counts, started right after phase 6 and run
   while the card works on phases 7-16 (``BackgroundCounts``; their
   host-bound times share the host with it): 0 failures, and each row's
   FLOPs a device times its chips at least ``model_flops`` less the
   products no step makes.
   Printed: each row's argument and temporary GB a device, its terms,
   collectives and bytes a device, its seconds, the pool's wall seconds
   and the seconds the phase waited for it; the line also has the whole
   script's seconds so far.

Then the ``kernels`` line, the ``nvidia-smi`` line and the closing
``{"ok": true, ...}`` line. Any failure raises and exits non-zero; without a
CUDA device nothing is printed to stdout.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint import ckpt as ckpt_mod  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import JaxTrainLayout  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticStream  # noqa
from repro_torch.ft import harness as ft_harness  # noqa: E402
from repro_torch.ft import runner as ft_runner  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import gmm as gmm_mod  # noqa: E402
from repro_torch.kernels import gmm_swiglu as swiglu_mod  # noqa: E402
from repro_torch.kernels import gmm_swiglu_bwd as bwd_mod  # noqa: E402
from repro_torch.kernels import swiglu_add as swa_mod  # noqa: E402
from repro_torch.kernels import work  # noqa: E402
from repro_torch.kernels.ref import (gmm_ref, gmm_swiglu_bwd_ref,  # noqa
                                     gmm_swiglu_ref, moe_ffn_ref)
from repro_torch.core import elastic  # noqa: E402
from repro_torch.core import executor as ex  # noqa: E402
from repro_torch.core import fusion as fu  # noqa: E402
from repro_torch.core.buckets import fit_ladder  # noqa: E402
from repro_torch.core.ssc import SSCCache  # noqa: E402
from repro_torch.configs import deepseek_moe_paper  # noqa: E402
from repro_torch.configs.shapes import (SHAPES, ShapeSpec,  # noqa: E402
                                        skip_reason)
from repro_torch.launch import bench_dropless as dropless_bench  # noqa
from repro_torch.launch import bench_ep_modes as ep_bench  # noqa: E402
from repro_torch.launch import bench_fused_dropless as fused_bench  # noqa
from repro_torch.launch import bench_swiglu_add as bench_mod  # noqa: E402
from repro_torch.launch import dropless as dropless_mod  # noqa: E402
from repro_torch.launch import dryrun as dryrun_mod  # noqa: E402
from repro_torch.launch import hillclimb as hc_mod  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.mesh import (counting_mesh, dist_mesh,  # noqa
                                     make_mesh, make_test_mesh)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.moe import (bridge_dispatch, capacity,  # noqa
                                    init_moe, moe_grouped,
                                    plan_from_routing, router_topk)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel.ep import (EPConfig, _pair_capacity,  # noqa
                                     make_moe_ep)
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.flash_decode import make_flash_decode  # noqa
from repro_torch.examples import quickstart as ex_quickstart  # noqa: E402
from repro_torch.examples import schedule_explorer as ex_explorer  # noqa
from repro_torch.examples import serve_decode as ex_serve  # noqa: E402
from repro_torch.examples import train_moe_e2e as ex_e2e  # noqa: E402

ARCH = "granite-moe-3b-a800m"
SLOTS, REQUESTS, PROMPT_LEN, MAX_NEW = 8, 16, 128, 32
# Kernel vs plain version on the card. fp32: the two sum up to 1536
# products in different orders; bf16: the tolerance of the JAX kernel tests.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# One prefill's last-token logits, kernels vs plain expert FFN, bf16 through
# 32 layers: |diff| <= LOGIT_TOL * max|logit|.
LOGIT_TOL = 5e-2
# Training: B x S tokens per step (the repo's train_4k sequence, global batch
# cut from 256 to 1), steps of which the first is warm-up.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 1, 4096, 4
# 2-layer train-step parity, kernels vs plain FFN (starting tolerances):
# loss within LOSS_TOL relative, each grad leaf's norm within GNORM_TOL.
PARITY_LAYERS, LOSS_TOL, GNORM_TOL = 2, 1e-2, 5e-2
# moe_expert_ffn(trainable=True)'s grads vs autograd through the plain FFN
# at the training shape: each grad's ||g - p|| / ||p|| at most
# FFN_GRAD_REL_TOL. The limit lies above the plain bf16 FFN's own distance
# from the same FFN in fp32 (a kernel that summed exactly would read that
# much), and below a control that feeds the plain FFN its operands with
# CONTROL_BITS fewer mantissa bits, which must exceed it (PERF.md §6).
FFN_GRAD_REL_TOL, CONTROL_BITS = 5e-3, 1
# Launches per layer per training step, with per-layer remat.
TRAIN_LAUNCHES = {"gmm_swiglu": 2, "gmm": 4, "gmm_swiglu_bwd": 1,
                  "swiglu_add_serial": 0, "swiglu_add_interleaved": 0}
# Row counts at each edge of the tensor-core GMM tiles (64 rows up to C = 64,
# then 128) and the main path's ragged capacities.
TILE_EDGES = (1, 2, 15, 16, 17, 27, 63, 64, 65, 127, 128, 129, 854)
# swiglu_add checks beyond the benchmark's sizes: M = 1000 is ragged,
# F = 36 not a multiple of the 16-byte vectors (8 bf16 or 4 fp32).
SWIGLU_ADD_CHECKS = [(M, F) for M in (256, 1000, 4096, 32768)
                     for F in (2048, 36)]
# Row counts of the dropless fragment's tiles: ragged, across the narrow
# body's CTA edges and on both sides of where the tiled body takes over
# (``gmm.tiled_takes``: 65 rows at N = 1536, 129 at 1024, 257 at 512), up
# to an expert's share of a 4096-token batch and beyond.
DROPLESS_ROWS = (1, 8, 9, 15, 17, 64, 65, 127, 128, 129, 256, 257, 683,
                 1001)
# The fp32 bodies' edges, E = 3, each in all four layouts: (C, K, N) with C
# past a 32- or 64-row tile (65 ... 1004; where x is a transposed view C is
# its contiguous dim, and only C = 68, 132, 684, 1004 keep it a multiple of
# 4 floats: the others check the small-row body there), K not a multiple
# of the 16-deep slab (1004: in the layouts that read K contiguous), N not
# a multiple of the 64- or 128-wide tile (1000); the weight gradients' (M,
# K, N) with K, the rows summed, ragged (683, 1001) where x is read
# transposed; and calls too small for the tiled body (C = 5 ... 31): K =
# 1004 ends in a partial 32-k stage and N = 996 in a partial 8-column
# block of the narrow body; K = 1538 read contiguous (not a multiple of 4
# floats) and N = 1002 where w is stored [K][N] are not TMA's, and run the
# small-row body, as does x read transposed.
DROPLESS_EDGES = (
    [(C, K, N, lay) for C in (65, 68, 129, 132, 683, 684, 1001, 1004)
     for K, N in ((1536, 1024), (512, 1536), (1024, 512))
     for lay in ((0, 0), (0, 1), (1, 0), (1, 1))]
    + [(C, K, N, lay) for C, K, N in ((684, 1004, 512), (132, 512, 1000))
       for lay in ((0, 0), (0, 1), (1, 0), (1, 1))]
    + [(M, K, N, (1, 0)) for M, N in ((1536, 1024), (512, 1536))
       for K in (683, 1001)]
    + [(C, K, N, lay) for C in (5, 17, 31)
       for K, N in ((1004, 996), (1538, 1024), (1536, 1002))
       for lay in ((0, 0), (0, 1), (1, 0), (1, 1))])
DROPLESS_TIMED_ROWS = 683       # an expert's mean share: 4096 x 8 / 48
# fp32 gmm's rows must not depend on the call's row count: C = 1 ... this,
# across the narrow body and the tiled body (which takes every call from
# FP32_TILED_MIN_ROWS rows on).
ROW_BITS_MAX = gmm_mod.FP32_TILED_MIN_ROWS + 8
# Full-depth dropless training: steps of 1 x 4096 tokens, the first warm-up
# (cut from 3 to make room for phase 19b: a step there is host-bound in
# good part, the executor's walk and a compile a lookup).
DROPLESS_STEPS = 2
# The same step when remat checkpointed each whole block, so that the
# backward ran every fragment's forward again (PERF.md §5; NVIDIA H100 80GB
# HBM3, 700.00 W): printed beside this run's numbers, compared with nothing.
WHOLE_BLOCK_CHECKPOINT = {"step_ms": [4291.99, 5444.44],
                          "max_memory_allocated_bytes": 67219756544,
                          "ssc_lookups_per_step": 96}
# PP fusion: stages, microbatches, the EP group and the tokens each stage's
# router plans from (a 4096-token batch in 2 microbatches).
PP_STAGES, PP_MICROBATCHES, PP_EP, PP_TOKENS = 2, 2, 4, 2048
# Elastic: the ep = 4 group losing ranks 1 and 3 (48 experts on 2 ranks).
ELASTIC_EP, ELASTIC_DEAD = 4, (1, 3)
# Online serving (phase 13): the forced-swap check at 2 full-width layers,
# 8 requests of MAX_NEW_SWAP new tokens, the swap forced before decode step
# SWAP_AT; the full-depth run with --slo-us at the predicted step of
# SLO_SLOTS busy slots and --max-queue ONLINE_QUEUE, so that the first
# REQUESTS - ONLINE_QUEUE offers are shed, each served request
# ONLINE_MAX_NEW new tokens (cut from MAX_NEW to keep the script within
# its time: the host-bound run takes ~1.6 s a decode step; cut from 16
# to make room for phase 19b).
SWAP_LAYERS, SWAP_AT, MAX_NEW_SWAP = 2, 2, 8
SLO_SLOTS, ONLINE_QUEUE, ONLINE_MAX_NEW = 6, 12, 8
# fp32 gmm calls timed at decode-tile row counts (E = 1, both GMM widths).
DECODE_TILE_ROWS = (1, 8)
# Expert parallelism (phase 14): EP virtual ranks on mesh 1 x EP, the
# launcher's capacity factor, steps of the full-depth runs (the first is
# warm-up), the modes in the order they run.
EP, EP_CF, EP_STEPS = 4, 4.0, 3
EP_MODES = ("hyperparallel", "baseline")
# The paper's §5.2 module at ep = 4 (8 experts a rank, K = 7168, F = 2048)
# with 8192 tokens a rank at the default capacity factor.
PAPER = deepseek_moe_paper.config(ep=EP, n_layers=1)
PAPER_TOKENS_PER_RANK = 8192
# Checkpoint and fault tolerance (phase 15): the training cell cut to
# PARITY_LAYERS layers; FT_STEPS steps, a checkpoint every FT_EVERY steps
# and at the last, the newest FT_KEEP kept; the crashed run dies before step
# FT_CRASH and resumes from the checkpoint at FT_EVERY.
FT_STEPS, FT_EVERY, FT_KEEP, FT_CRASH = 4, 2, 1, 3
# The model families (phase 16). (a) Path consistency at full width in fp32,
# cut in depth: arch -> (layers, prompt tokens, teacher-forced decode
# steps); recurrentgemma's prompt passes its 2,048-token window, so its
# ring wraps; mamba2's prompt is below its 256-token chunk and prompt +
# steps a multiple of it (the reference's SSD length rule). Each reading
# within FAMILY_TOL x max|logit| of the forward on the same tokens.
FAMILY_CONSISTENCY = {
    "llama3_2-3b": (2, 128, 4), "qwen2-1_5b": (2, 128, 4),
    "olmo-1b": (2, 128, 4), "gemma-2b": (2, 128, 4),
    "mamba2-1_3b": (2, 192, 64), "recurrentgemma-2b": (5, 2100, 4)}
FAMILY_TOL = 1e-3
# (b), (c): serving (phase 4's traffic) and FAMILY_TRAIN_STEPS training
# steps of 1 x TRAIN_SEQ tokens at full width and depth, bf16.
FAMILY_FULL = ("llama3_2-3b", "mamba2-1_3b", "recurrentgemma-2b")
FAMILY_TRAIN_STEPS = 3
# (d) dbrx-132b at full width cut from 40 layers to DBRX_LAYERS (132 B
# parameters do not fit one card; 2 layers are ~15 GB), serving
# DBRX_REQUESTS requests; (e) the same layers' training step.
DBRX, DBRX_LAYERS, DBRX_REQUESTS = "dbrx-132b", 2, 8
# The audio and vlm families (phase 17). (a) fp32 at full width cut to
# AV_LAYERS layers: internvl2's prefill over its 256 patches + PROMPT_LEN
# tokens and VLM_STEPS teacher-forced decode steps within FAMILY_TOL x
# max|logit| of the forward with the same patches; hubert's encoder over
# AUDIO_FRAMES frames on the card within AUDIO_TOL x max|logit| of the
# same forward on the CPU.
AUDIO, VLM = "hubert-xlarge", "internvl2-26b"
AV_LAYERS, VLM_STEPS, AUDIO_FRAMES, AUDIO_TOL = 2, 4, 512, 1e-4
# (b) serving at full depth, bf16: internvl2 on phase 4's traffic, then
# prefill_step on PATCH_BATCH sequences of 256 patches + PROMPT_LEN tokens;
# hubert's prefill_step at prefill_32k's frames with its batch of 32 cut to
# 1. (c) training, bf16 with fp32 AdamW, FAMILY_TRAIN_STEPS steps of
# 1 x TRAIN_SEQ: hubert at full depth, internvl2 cut from 48 layers to
# VLM_TRAIN_LAYERS (its 19.86 B parameters take 12 bytes each of AdamW
# state). Each timed step call is repeated AV_REPEATS times after a warm-up
# (cut from 3 to keep the script within its time: hubert's prefill takes
# ~20 s a call).
PATCH_BATCH, VLM_TRAIN_LAYERS, AV_REPEATS = 8, 4, 1
# (d) the dry run over every arch x shape cell on the meta device, in
# DRYRUN_WORKERS processes with phase 21 (b)'s counts (host work: they run
# beside phases 7-16, 4 of the host's 8 cores, the others left to the
# script), and at each run's own
# batch and depth: the share of the roofline a run reached,
# max(t_compute, t_memory) / its measured time, may not exceed SHARE_MAX
# (a count below the work done).
DRYRUN_WORKERS, SHARE_MAX = 4, 1.05
# The one-card tools (phase 18). (a) The hill-climb's three cells at the
# reference's global batches under its default variants, counted on the
# meta device over TOOLS_MESH virtual ranks in TOOLS_WORKERS processes.
# (b) On the card, each variant's real step (``hillclimb.variant_steps``)
# beside its count at the same cut: granite's train_4k at full width cut to
# TOOLS_LAYERS layers and batch 1 under GRANITE_VARIANTS, TOOLS_STEPS steps
# each (the first warm-up); llama3.2-3b's decode_32k at full depth, batch
# cut from 128 to DECODE_BATCH, under DECODE_VARIANTS, one warm-up and
# DECODE_STEPS teacher-forced steps from a cache of random keys and values;
# hubert-xlarge's train_4k baseline at TOOLS_LAYERS layers. The two decode
# paths are held to each other in fp32 at full width cut to PARITY_LAYERS
# layers (FAMILY_TOL x max|logit|); at full depth in bf16 their gap is
# printed. (c) The four examples, train_moe_e2e for E2E_STEPS steps.
TOOLS_MESH, TOOLS_WORKERS = (1, EP), 6
TOOLS_CELL_VARIANTS = ("baseline", "opt")
GRANITE_VARIANTS = ("baseline", "zero1", "zero1_noremat", "ep_dp",
                    "ep_dp_savemoe", "ep_dp_baselinea2a")
TOOLS_LAYERS, TOOLS_STEPS = 4, 3
LLAMA = "llama3.2-3b"
DECODE_VARIANTS, DECODE_BATCH, DECODE_STEPS = (
    ("baseline", "flashdecode_off"), 8, 8)
E2E_STEPS = 10
# Training across processes (phase 19): DIST_PROCS processes, one rank
# each, on the one card over gloo (NCCL refuses two ranks on one card),
# mesh DIST_MESH, granite at full width cut to DIST_LAYERS layers,
# DIST_STEPS steps of DIST_BATCH x TRAIN_SEQ tokens (train_4k's global batch
# cut from 256 to 4: one row a rank; a warm-up step and one timed, cut from
# 3 steps to keep the script within its time), in each of DIST_MODES.
DIST_PROCS, DIST_MESH, DIST_LAYERS, DIST_STEPS = 4, (2, 2), 2, 2
DIST_BATCH = 4
DIST_MODES = ("zero1", "ep_dp")
# Dropless training across processes (phase 19b): phase 19's processes,
# mesh, layers and steps with ``--dropless`` (DroplessConfig(ep = the model
# axis), the launcher's default bucket), DIST_BATCH rows x DROPLESS_DIST_SEQ
# tokens (4,096: phase 8's fragment and phase 9's parity step), in ep_dp
# (the reference README's mode) and tp_sp (the reference's default).
DROPLESS_DIST_SEQ = 1024
DROPLESS_DIST_MODES = ("ep_dp", "tp_sp")
# A routed expert's gmm calls in the fragment a layer a step: GMM1 and GMM2
# forward, the backward's recompute of both, their activation grads and
# their weight grads (an expert that no token picks has no tile).
FRAGMENT_GMM_PER_EXPERT = 8
# Phase 20: phase 19's setup in mode tp_sp, without then with FSDP (the
# run's name -> make_steps' fsdp=), the last one checkpointed.
DIST_TP_RUNS = {"tp_sp": False, "tp_sp_fsdp": True}
# Phase 20 (b): the other families in tp_sp across DIST_PROCS processes (one
# spawn for all), at full width cut in depth: arch -> (layers, fsdp=);
# recurrentgemma keeps one super-block and its full config's 2-layer tail
# (26 = 8 x 3 + 2), internvl2 its default FSDP. DIST_FAMILY_STEPS steps of
# DIST_BATCH x TRAIN_SEQ tokens (internvl2: its 256 patches before them;
# hubert: frames), the first a warm-up.
DIST_FAMILIES = {"gemma-2b": (2, False), "mamba2-1.3b": (2, False),
                 "recurrentgemma-2b": (5, False),
                 "internvl2-26b": (2, True), "hubert-xlarge": (2, False)}
DIST_FAMILY_STEPS = 2
# Phase 20 (c): serving in phase 20 (b)'s spawn, after the trainings: a
# prefill of each layout's rows x SERVE_PROMPT tokens (recurrentgemma
# SERVE_PROMPTS', so that its decode wraps the 2,048-slot ring; the smoke
# configs SERVE_SMOKE_PROMPT, a 16-slot ring wrapped alike), then SERVE_NEW
# teacher-forced decode steps. Layouts: name -> (arch, mode, rows); granite
# (EP through the GMM kernels) in tp_sp and, at SERVE_REPEAT_ROWS rows, in
# zero1 and ep_dp (2 rows on 2x2 repeat over model; 4 would split over both
# axes, a cache spec naming model twice, which both packages refuse); the
# other families in tp_sp. SERVE_NEW was cut from 8 to make room for phase
# 19b (host-bound steps over the loopback; the rings still wrap at the
# first).
SERVE_PROMPT, SERVE_SMOKE_PROMPT, SERVE_NEW = 512, 16, 4
SERVE_PROMPTS = {"recurrentgemma-2b": 2048}
SERVE_REPEAT_ROWS = 2
SERVE_LAYOUTS = {f"{ARCH}/tp_sp": (ARCH, "tp_sp", DIST_BATCH),
                 **{f"{ARCH}/{m}": (ARCH, m, SERVE_REPEAT_ROWS)
                    for m in DIST_MODES},
                 **{f"{a}/tp_sp": (a, "tp_sp", DIST_BATCH)
                    for a in DIST_FAMILIES}}
# Phase 20 (b)'s fp32 yardstick (the printed bf16_vs_fp32 gap, no gate)
# runs for mamba2 alone, the SSD's bf16 question (ROADMAP Queue 3 · 6).
DIST_FP32_ARCHS = ("mamba2-1.3b",)
# Phase 21 (b): (arch, mode, mesh) counts of train_4k on the reference's
# production meshes, with phase 17 (d)'s, started after phase 6 (the
# kernels', serving's and training's headline numbers).
PROD_MODE_ARCHS = (ARCH, "dbrx-132b")
PROD_CELLS = ([(a, "tp_sp", "16x16") for a in dryrun_mod.DRYRUN_ARCHS]
              + [(a, mode, mesh) for a in PROD_MODE_ARCHS
                 for mode in ("zero1", "ep_dp")
                 for mesh in dryrun_mod.PRODUCTION])
# ... and these serving cells, in tp_sp on 16x16: (arch, shape).
PROD_SERVE_CELLS = ((ARCH, "prefill_32k"), (ARCH, "decode_32k"),
                    ("dbrx-132b", "decode_32k"), ("llama3.2-3b", "decode_32k"),
                    ("mamba2-1.3b", "long_500k"),
                    ("recurrentgemma-2b", "long_500k"),
                    ("internvl2-26b", "prefill_32k"),
                    ("hubert-xlarge", "prefill_32k"))

KERNELS = {
    "gmm_swiglu": dict(fn=swiglu_mod.gmm_swiglu, plain=gmm_swiglu_ref,
                       two=True,
                       source="src/repro_torch/kernels/csrc/gmm_swiglu.cu",
                       replaces="src/repro/kernels/gmm_swiglu.py:47"),
    "gmm": dict(fn=gmm_mod.gmm, plain=gmm_ref, two=False,
                source="src/repro_torch/kernels/csrc/gmm.cu",
                replaces="src/repro/kernels/gmm.py:43"),
    "gmm_swiglu_bwd": dict(
        fn=bwd_mod.gmm_swiglu_bwd, plain=gmm_swiglu_bwd_ref,
        source="src/repro_torch/kernels/csrc/gmm_swiglu_bwd.cu",
        replaces="src/repro/kernels/gmm_swiglu_bwd.py:91"),
    "swiglu_add_serial": dict(
        source="src/repro_torch/kernels/csrc/swiglu_add.cu",
        replaces="src/repro/kernels/swiglu_add.py:47"),
    "swiglu_add_interleaved": dict(
        source="src/repro_torch/kernels/csrc/swiglu_add.cu",
        replaces="src/repro/kernels/swiglu_add.py:73"),
}
# Each entry point's launch counter: (module, attribute).
COUNTERS = {"gmm_swiglu": (swiglu_mod, "launches"),
            "gmm": (gmm_mod, "launches"),
            "gmm_swiglu_bwd": (bwd_mod, "launches"),
            "swiglu_add_serial": (swa_mod, "launches_serial"),
            "swiglu_add_interleaved": (swa_mod, "launches_interleaved")}


def reset_launches() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)
    bwd_mod.launches_tc = 0
    gmm_mod.launches_tc = 0
    swiglu_mod.launches_tc = 0
    gmm_mod.launches_fp32_tiled = 0
    gmm_mod.launches_fp32_narrow = 0
    gmm_mod.launches_fp32_small = 0


def read_launches() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in
            COUNTERS.items()}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def eager_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of ``fn()`` by CUDA events around ``iters`` calls made from
    Python: where the host takes longer to launch a call than the device to
    run it (decode), this is the host's time."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = 200) -> float:
    """Host µs to issue one call of ``fn()``, over ``calls`` calls made back
    to back with no synchronisation, as a decode step makes them."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e6 * dt / calls


def cuda_ms(fn, iters: int = 20, reps: int = 3) -> float:
    """Mean device time of ``fn()``: ``iters`` calls captured in one CUDA
    graph after a warm-up call, replayed ``reps`` times between CUDA events.
    The replay leaves the host's launch time out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * reps)


def ptxas_report(log: str) -> list:
    """Registers, static shared memory and spills of each tensor-core
    kernel (namespaces ``gmmtc`` and ``gsbtc``) and of each instance of
    ``gmm``'s fp32 tiled body (``gmmf``; its ring is dynamic shared
    memory), narrow body (``gmmn``; the same) and small-row body (``gmms``)
    in a ``-Xptxas -v`` build log."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"gmm_tc_kernelI(.*)EEv", m.group(1))
            b = re.search(r"gsbtc10bwd_kernelI(.*)EEv", m.group(1))
            f = re.search(r"gmmf12tiled_kernelI(.*)EEv", m.group(1))
            g = re.search(r"gmms12small_kernelI(.*)EEv", m.group(1))
            n = re.search(r"gmmn13narrow_kernelI(.*)EEv", m.group(1))
            cur = None
            if t:
                a = re.findall(r"L[ib](\d+)E", t.group(1) + "E")
                cur = {"kernel": "gmmtc::gmm_tc_kernel", "nwg": int(a[0]),
                       "nb": int(a[1]), "ta": int(a[2]), "tb": int(a[3]),
                       "swiglu": bool(int(a[4]))}
            elif b:
                a = re.findall(r"L[ib](\d+)E", b.group(1) + "E")
                cur = {"kernel": "gsbtc::bwd_kernel",
                       "mode": ("gu", "dx", "dw")[int(a[0])],
                       "fp32_out": bool(int(a[1]))}
            elif f:
                a = [int(v) for v in re.findall(r"Li(\d+)E", f.group(1) + "E")]
                cur = {"kernel": "gmmf::tiled_kernel", "bm": a[0],
                       "bn": a[1], "tm": a[2], "tn": a[3], "ta": a[4],
                       "tb": a[5]}
            elif g:
                a = [int(v) for v in re.findall(r"L[ib](\d+)E",
                                                g.group(1) + "E")]
                cur = {"kernel": "gmms::small_kernel", "rb": a[0],
                       "ta": a[1], "tb": a[2], "w16": bool(a[3])}
            elif n:
                a = [int(v) for v in re.findall(r"Li(\d+)E", n.group(1) + "E")]
                cur = {"kernel": "gmmn::narrow_kernel", "tm": a[0],
                       "tn": a[1], "tb": a[2]}
            if cur:
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            sm = re.search(r"(\d+) bytes smem", line)
            cur.update(registers=int(m.group(1)),
                       static_smem=int(sm.group(1)) if sm else 0)
    return out


def bound(E, C, K, N, two, dtype):
    """Least time (ms) for the call and what sets it: each input read once,
    the output written once, over HBM; 2 ops per multiply-add over the
    dtype's peak (``kernels.work``, the formulas the dry run counts)."""
    return work.bound_ms(*work.gmm_work(E, C, K, N, dtype, two), dtype)


def bwd_bound(E, C, K, F, dtype):
    """gmm_swiglu_bwd: x, w_in and dout read once, the fp32 dx and dw
    written once; the recompute of g and u, dx and dW are three products of
    2·E·C·K·2F operations."""
    return work.bound_ms(*work.gmm_swiglu_bwd_work(E, C, K, F, dtype),
                         dtype)


def kernel_case(name, E, C, K, N, dtype, gen, timed, layouts=(0, 0),
                repeat=False):
    """One call of a forward kernel against its plain version. ``layouts``
    (gmm only): x, w passed as transposed views of [E, K, C], [E, N, K]
    tensors where 1, the way ``gmm_trainable``'s backward passes them; the
    plain version gets contiguous copies. ``repeat``: a second call must be
    bit-equal to the first."""
    spec = KERNELS[name]
    w_cols = 2 * N if spec["two"] else N
    la, lb = layouts
    x = torch.randn((E, K, C) if la else (E, C, K), generator=gen,
                    device="cuda").to(dtype)
    w = (torch.randn((E, w_cols, K) if lb else (E, K, w_cols),
                     generator=gen, device="cuda") * K ** -0.5).to(dtype)
    x = x.transpose(1, 2) if la else x
    w = w.transpose(1, 2) if lb else w
    tiled, narrow = gmm_mod.launches_fp32_tiled, gmm_mod.launches_fp32_narrow
    got = spec["fn"](x, w)
    tiled = gmm_mod.launches_fp32_tiled - tiled
    narrow = gmm_mod.launches_fp32_narrow - narrow
    want = spec["plain"](x.contiguous(), w.contiguous())
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype]
    ok = bool((err <= tol + tol * want.float().abs()).all())
    row = {"kernel": name, "E": E, "C": C, "K": K, "N": N,
           "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": float(err.max()), "tol": tol, "ok": ok}
    if name == "gmm" and dtype == torch.float32:
        row.update(body=gmm_mod.fp32_body(x, w), tiled_launches=tiled,
                   narrow_launches=narrow)
    if layouts != (0, 0):
        row["layouts"] = {"x": "transposed view" if la else "contiguous",
                          "w": "transposed view" if lb else "contiguous"}
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{row}")
    if repeat or timed:
        row["repeat_bit_equal"] = bool(torch.equal(got, spec["fn"](x, w)))
        if not row["repeat_bit_equal"]:
            raise AssertionError(f"{name}: two calls on the same input "
                                 f"differ: {row}")
    if timed:
        b_ms, b_by = bound(E, C, K, N, spec["two"], dtype)
        # timed="device": device times only, over fewer calls (the paper's
        # widths, where one call takes milliseconds).
        kw = {} if timed is True else {"iters": 3, "reps": 2}
        row.update(ms=cuda_ms(lambda: spec["fn"](x, w), **kw),
                   plain_ms=cuda_ms(lambda: spec["plain"](x, w), **kw),
                   library_ms=(cuda_ms(lambda: torch.bmm(x, w), **kw)
                               if name == "gmm" else None),
                   bound_ms=b_ms, bound_by=b_by)
        if timed is True:
            row.update(eager_ms=eager_ms(lambda: spec["fn"](x, w)),
                       host_us=host_us(lambda: spec["fn"](x, w)))
        if spec["two"]:
            # Not the same function: the [E, C, 2F] product without SwiGLU,
            # stored to device memory.
            row["gemm_only_ms"] = cuda_ms(lambda: torch.bmm(x, w), **kw)
    return row


def bwd_case(E, C, K, F, dtype, gen, timed):
    """gmm_swiglu_bwd against its plain version: both fp32 outputs (the JAX
    contract), elementwise within TOL. The call is made twice and must be
    bit-equal; in bf16 the main path's call (``out_dtype=bfloat16``) must
    equal the fp32 outputs rounded. The row names the body that ran
    (``bwd_mod.tensor_core_body``). Timed: the main path's call by CUDA
    graph replay (``ms``), the fp32-output call's (``fp32_out_ms``), the
    plain version's, the bound, and as a yardstick ``gemm_only_ms``: the
    three ``torch.bmm`` products of the same sizes (recompute, dx, dW),
    which are not the same function."""
    spec = KERNELS["gmm_swiglu_bwd"]
    x = torch.randn((E, C, K), generator=gen, device="cuda").to(dtype)
    w4 = (torch.randn((E, K, 2, F), generator=gen, device="cuda")
          * K ** -0.5).to(dtype)
    dout = torch.randn((E, C, F), generator=gen, device="cuda").to(dtype)
    tc = bwd_mod.launches_tc
    got = spec["fn"](x, w4, dout)
    tc = bwd_mod.launches_tc - tc
    want = spec["plain"](x, w4, dout)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    err, ok = 0.0, True
    for g, p in zip(got, want):
        for ge, pe in zip(g, p):        # an expert at a time: dbrx's fp32
            e = (ge - pe).abs()         # dW is 8.5 GB
            err = max(err, float(e.max()))
            ok = ok and bool((e <= tol + tol * pe.abs()).all())
    del want
    row = {"kernel": "gmm_swiglu_bwd", "E": E, "C": C, "K": K, "N": F,
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
           "tol": tol, "ok": ok,
           "body": "tensor_cores" if tc else "fma"}
    if not ok:
        raise AssertionError(f"gmm_swiglu_bwd disagrees with its plain "
                             f"version: {row}")
    row["repeat_bit_equal"] = all(torch.equal(a, b) for a, b in
                                  zip(got, spec["fn"](x, w4, dout)))
    if not row["repeat_bit_equal"]:
        raise AssertionError(f"gmm_swiglu_bwd: two calls on the same input "
                             f"differ: {row}")
    if dtype == torch.bfloat16:
        out_bf16 = spec["fn"](x, w4, dout, out_dtype=dtype)
        row["bf16_out_is_fp32_rounded"] = all(
            torch.equal(a, b.to(dtype)) for a, b in zip(out_bf16, got))
        if not row["bf16_out_is_fp32_rounded"]:
            raise AssertionError(f"gmm_swiglu_bwd's bf16 outputs are not "
                                 f"its fp32 outputs rounded: {row}")
    del got
    if timed:
        b_ms, b_by = bwd_bound(E, C, K, F, dtype)
        w_in = w4.view(E, K, 2 * F)
        dgu = torch.randn((E, C, 2 * F), generator=gen,
                          device="cuda").to(dtype)
        # timed="device": fewer calls a graph (the EP shapes, where one call
        # takes milliseconds and its fp32 outputs hundreds of MB).
        it, pit = (10, 10) if timed is True else (3, 2)
        row.update(
            ms=cuda_ms(lambda: spec["fn"](x, w4, dout, out_dtype=dtype),
                       it, 2),
            fp32_out_ms=cuda_ms(lambda: spec["fn"](x, w4, dout), it, 2),
            plain_ms=cuda_ms(lambda: spec["plain"](x, w4, dout), pit, 1),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            gemm_only_ms=cuda_ms(lambda: (
                torch.bmm(x, w_in), torch.bmm(dgu, w_in.transpose(1, 2)),
                torch.bmm(x.transpose(1, 2), dgu)), it, 2))
    return row


def _beyond(got, want, tol):
    """Max |got - want| and the count of entries beyond tol + tol·|want|."""
    e = (got.float() - want.float()).abs()
    return float(e.max()), int((e > tol + tol * want.float().abs()).sum())


def _rel_err(got, want):
    """||got - want|| / ||want||."""
    want = want.float()
    return float((got.float() - want).norm() / want.norm())


def round_off(t, bits):
    """bf16 ``t`` with ``bits`` fewer mantissa bits, rounded to nearest."""
    i = t.float().view(torch.int32)
    i = (i + (1 << (15 + bits))) & -(1 << (16 + bits))
    return i.view(torch.float32).to(t.dtype)


def ffn_grads(fn, x, w_in, w_down, dy):
    """dx, dw_in and dw_down of ``fn(x, w_in, w_down)`` under cotangent
    ``dy``, by autograd."""
    leaves = [t.clone().requires_grad_(True) for t in (x, w_in, w_down)]
    fn(*leaves).backward(dy)
    return [t.grad for t in leaves]


def trainable_ffn_case(E, C, D, Fe, gen):
    """moe_expert_ffn(trainable=True)'s dx, dw_in and dw_down, held two ways.

    Step by step, elementwise within TOL: each step of its backward against
    the plain version of that step on the kernel path's own bf16
    intermediates: h = gmm_swiglu(x, w_in) and dh = gmm(dy, w_downᵀ) against
    their plain versions; dw_down against gmm_ref(hᵀ, dy); dx and dw_in
    against gmm_swiglu_bwd_ref(x, w_in, dh). The kernels are
    bit-deterministic, so h and dh recomputed here are the tensors autograd
    used.

    End to end, against autograd through the plain FFN: each grad's
    ||g - p|| / ||p|| within FFN_GRAD_REL_TOL, and the same reading of the
    lower-precision control beyond it; the row also gives both paths'
    readings against the plain FFN in fp32. Elementwise, a few thousand near-zero
    entries of dw_in and dw_down (sums of ~854 cancelling terms) lie beyond
    TOL there: the two paths round h and dh to bf16 from fp32 sums taken in
    different orders, and one ulp of an intermediate moves such a sum by
    more than its own size. Their counts are reported, not held."""
    dt = torch.bfloat16
    x = torch.randn((E, C, D), generator=gen, device="cuda").to(dt)
    w_in = (torch.randn((E, D, 2 * Fe), generator=gen, device="cuda")
            * D ** -0.5).to(dt)
    w_down = (torch.randn((E, Fe, D), generator=gen, device="cuda")
              * Fe ** -0.5).to(dt)
    dy = torch.randn((E, C, D), generator=gen, device="cuda").to(dt)
    names = ("dx", "dw_in", "dw_down")
    got = ffn_grads(lambda *a: ops.moe_expert_ffn(*a, trainable=True),
                    x, w_in, w_down, dy)
    plain = ffn_grads(moe_ffn_ref, x, w_in, w_down, dy)
    control = ffn_grads(moe_ffn_ref, *(round_off(t, CONTROL_BITS)
                                       for t in (x, w_in, w_down, dy)))
    fp32 = ffn_grads(moe_ffn_ref, *(t.float() for t in (x, w_in, w_down,
                                                        dy)))
    h = swiglu_mod.gmm_swiglu(x, w_in)
    dh = gmm_mod.gmm(dy, w_down.transpose(1, 2))
    dx_p, dw4_p = gmm_swiglu_bwd_ref(x, w_in.view(E, D, 2, Fe), dh)
    steps = {"h": (h, gmm_swiglu_ref(x, w_in)),
             "dh": (dh, gmm_ref(dy, w_down.transpose(1, 2).contiguous())),
             "dx": (got[0], dx_p.to(dt)),
             "dw_in": (got[1], dw4_p.view(E, D, 2 * Fe).to(dt)),
             "dw_down": (got[2], gmm_ref(h.transpose(1, 2).contiguous(), dy))}
    torch.cuda.synchronize()
    tol = TOL[dt]
    out = {k: _beyond(g, p, tol) for k, (g, p) in steps.items()}
    rel = {k: _rel_err(g, p) for k, g, p in zip(names, got, plain)}
    rel_control = {k: _rel_err(c, p) for k, c, p in zip(names, control,
                                                        plain)}
    rel_fp32 = {who: {k: _rel_err(g, p) for k, g, p in zip(names, gs,
                                                              fp32)}
                for who, gs in (("kernels", got), ("plain", plain))}
    beyond = {k: _beyond(g, p, tol) for k, g, p in zip(names, got, plain)}
    row = {"kernel": "moe_expert_ffn(trainable=True)", "E": E, "C": C,
           "D": D, "F": Fe, "dtype": "bfloat16",
           "max_abs_err": {k: v[0] for k, v in out.items()}, "tol": tol,
           "steps_ok": all(v[1] == 0 for v in out.values()),
           "end_to_end_vs_plain_ffn": {
               "rel_err": rel, "rel_tol": FFN_GRAD_REL_TOL,
               "control_bits": CONTROL_BITS, "control_rel_err": rel_control,
               "rel_err_vs_fp32_ffn": rel_fp32,
               "max_abs_err": {k: v[0] for k, v in beyond.items()},
               "beyond_tol": {k: v[1] for k, v in beyond.items()},
               "entries": {k: p.numel() for k, p in zip(names, plain)}}}
    row["end_to_end_ok"] = all(v <= FFN_GRAD_REL_TOL for v in rel.values())
    row["control_caught"] = all(v > FFN_GRAD_REL_TOL
                                for v in rel_control.values())
    row["ok"] = (row["steps_ok"] and row["end_to_end_ok"]
                 and row["control_caught"])
    if not row["ok"]:
        raise AssertionError(f"trainable expert FFN grads differ from the "
                             f"plain FFN's, or the end-to-end limit does "
                             f"not catch the control: {row}")
    return row


def check_kernels(cfg):
    """Phase 3: every kernel against its plain version on the card."""
    mc = cfg.moe
    E, D, Fe = mc.e_total, cfg.d_model, mc.d_expert
    c_dec8, c_dec4 = capacity(SLOTS, mc), capacity(SLOTS // 2, mc)
    c_pre = capacity(PROMPT_LEN, mc)
    c_train = capacity(TRAIN_BATCH * TRAIN_SEQ, mc)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    # The serving path's shapes: (C, K, N) of gmm_swiglu (K=D, N=F) and gmm
    # (K=F, N=D), timed in the model's dtype.
    path = {"decode8": c_dec8, "decode4": c_dec4, "prefill": c_pre}
    for dtype in (torch.bfloat16, torch.float32):
        for tag, C in path.items():
            for name, (K, N) in (("gmm_swiglu", (D, Fe)), ("gmm", (Fe, D))):
                r = kernel_case(name, E, C, K, N, dtype, gen,
                                timed=dtype == torch.bfloat16)
                r["shape"] = tag
                rows.append(r)
    # The training shape, bf16: the forward kernels, gmm's too as the two
    # calls of GMM2's backward on the views gmm_trainable passes (dx = dy·wᵀ
    # sums over D with w [E, F, D] read transposed; dw = xᵀ·dy sums over C
    # with x [E, C, F] read transposed), then the backward kernel.
    for tag, name, C, K, N, lay in (
            ("train", "gmm_swiglu", c_train, D, Fe, (0, 0)),
            ("train", "gmm", c_train, Fe, D, (0, 0)),
            ("train_bwd_dx", "gmm", c_train, D, Fe, (0, 1)),
            ("train_bwd_dw", "gmm", Fe, c_train, D, (1, 0))):
        r = kernel_case(name, E, C, K, N, torch.bfloat16, gen, timed=True,
                        layouts=lay)
        r["shape"] = tag
        rows.append(r)
    # Every tile edge of the tensor-core kernels at the model's widths.
    for C in TILE_EDGES:
        for name, (K, N) in (("gmm_swiglu", (D, Fe)), ("gmm", (Fe, D))):
            r = kernel_case(name, E, C, K, N, torch.bfloat16, gen,
                            timed=False, repeat=True)
            r["shape"] = "tile_edge"
            rows.append(r)
    r = bwd_case(E, c_train, D, Fe, torch.bfloat16, gen, timed=True)
    r["shape"] = "train"
    rows.append(r)
    if r["body"] != "tensor_cores":
        raise AssertionError(f"the training shape's gmm_swiglu_bwd ran the "
                             f"FMA body: {r}")
    for C in TILE_EDGES:
        r = bwd_case(E, C, D, Fe, torch.bfloat16, gen, timed=False)
        r["shape"] = "tile_edge"
        rows.append(r)
    rows.append(trainable_ffn_case(E, c_train, D, Fe, gen))
    rows += ep_kernel_rows(cfg, gen)
    rows += dist_kernel_rows(cfg, gen)
    rows += dbrx_kernel_rows(gen)
    for dtype in (torch.bfloat16, torch.float32):
        for E_, C, K, F in ((2, 128, 64, 128), (3, 64, 96, 64),
                            (3, 27, 1536, 40), (3, 1, 1536, 18)):
            rows.append(bwd_case(E_, C, K, F, dtype, gen, False))
        # Ragged shapes of the CPU tests (N = 160 and 18 are not multiples
        # of the 64-column tile; 18 is not a multiple of the 4-wide vectors).
        for E_, C, K, N in ((1, 128, 64, 128), (4, 256, 192, 256),
                            (3, 64, 96, 160), (8, 512, 128, 64),
                            (3, 1, 1536, 18), (3, 2, 1536, 40),
                            (3, 27, 1536, 160)):
            rows.append(kernel_case("gmm", E_, C, K, N, dtype, gen, False))
        # The backward's layouts at ragged shapes: the tensor-core body where
        # a tensor map fits (C = 136), the FMA body where not (C = 27, N = 18).
        for E_, C, K, N in ((3, 27, 40, 24), (3, 136, 96, 160),
                            (2, 64, 854, 18)):
            for lay in ((0, 1), (1, 0), (1, 1)):
                rows.append(kernel_case("gmm", E_, C, K, N, dtype, gen,
                                        False, layouts=lay))
        for E_, C, K, F in ((2, 128, 64, 128), (4, 192, 96, 64),
                            (1, 256, 128, 384), (3, 1, 1536, 18),
                            (3, 2, 1536, 40), (3, 27, 1536, 160)):
            rows.append(kernel_case("gmm_swiglu", E_, C, K, F, dtype, gen,
                                    False))
    return rows, {"decode8": c_dec8, "decode4": c_dec4, "prefill": c_pre,
                  "train": c_train, **ep_capacities(cfg),
                  "dist_train": dist_capacity(cfg),
                  **dbrx_capacities()}


def ep_capacities(cfg):
    """The EP pair capacities: granite's training step at ep = EP, and the
    paper module's at its default capacity factor."""
    return {"ep_train": _pair_capacity(TRAIN_BATCH * TRAIN_SEQ // EP,
                                       cfg.moe, EP, EP_CF),
            "paper": _pair_capacity(PAPER_TOKENS_PER_RANK, PAPER.moe, EP,
                                    EPConfig.capacity_factor)}


def ep_kernel_rows(cfg, gen):
    """Phase 14 (a), run in phase 3: the GMM kernels at the EP paths'
    shapes. Granite's training step at ep = EP: e_loc experts, a ring
    chunk's C_pair rows and a baseline call's EP x C_pair, forward and
    backward, each call twice and bit-equal. The paper module's widths
    (E = 8 a rank, K = 7168, F = 2048) at a ring chunk's C and a baseline
    call's EP x C: each held against its plain version and timed beside
    its bound and, for gmm, ``torch.bmm``; the backward at the ring
    chunk."""
    caps = ep_capacities(cfg)
    e_loc, D, Fe = cfg.moe.e_total // EP, cfg.d_model, cfg.moe.d_expert
    rows = []
    for tag, C in (("ep_ring", caps["ep_train"]),
                   ("ep_baseline", EP * caps["ep_train"])):
        for name, (K, N) in (("gmm_swiglu", (D, Fe)), ("gmm", (Fe, D))):
            r = kernel_case(name, e_loc, C, K, N, torch.bfloat16, gen,
                            timed="device", repeat=True)
            rows.append(dict(r, shape=tag))
        r = bwd_case(e_loc, C, D, Fe, torch.bfloat16, gen, timed="device")
        if r["body"] != "tensor_cores":
            raise AssertionError(f"EP gmm_swiglu_bwd ran the FMA body: {r}")
        rows.append(dict(r, shape=tag))
    pe, pd, pf = (PAPER.moe.e_total // EP, PAPER.d_model,
                  PAPER.moe.d_expert)
    for tag, C in (("paper_ring", caps["paper"]),
                   ("paper_baseline", EP * caps["paper"])):
        for name, (K, N) in (("gmm_swiglu", (pd, pf)), ("gmm", (pf, pd))):
            r = kernel_case(name, pe, C, K, N, torch.bfloat16, gen,
                            timed="device")
            rows.append(dict(r, shape=tag))
            torch.cuda.empty_cache()
    r = bwd_case(pe, caps["paper"], pd, pf, torch.bfloat16, gen, "device")
    if r["body"] != "tensor_cores":
        raise AssertionError(f"EP gmm_swiglu_bwd ran the FMA body: {r}")
    rows.append(dict(r, shape="paper_ring"))
    torch.cuda.empty_cache()
    return rows


def dist_capacity(cfg) -> int:
    """Phase 19's ring chunk: C_pair of a rank's tokens at ep =
    DIST_MESH[-1], the tokens ``rules.batch_spec`` gives a rank of
    DIST_BATCH x TRAIN_SEQ in each of DIST_MODES and in phase 20's tp_sp
    (zero1's sequence chunks of the model row's rows are as many)."""
    pcfg = train_mod.pad_experts(cfg, DIST_MESH[-1])
    mesh = _ShapeMesh(DIST_MESH)
    shape = (DIST_BATCH, TRAIN_SEQ)
    tokens = {math.prod(sharding.block_shape(shape, sharding.ShardingRules(
        pcfg, mesh, mode=m).batch_spec({"tokens": shape})["tokens"], mesh))
        for m in DIST_MODES + ("tp_sp",)}
    if len(tokens) != 1:
        raise AssertionError(f"phases 19 and 20 give a rank {tokens} "
                             f"tokens")
    return _pair_capacity(tokens.pop(), pcfg.moe, DIST_MESH[-1], EP_CF)


def dist_kernel_rows(cfg, gen):
    """Phase 19's GMM shapes, run in phase 3: e_total / DIST_MESH[-1]
    experts a rank and a ring chunk's C_pair rows (``dist_capacity``):
    gmm_swiglu, gmm forward and the two gmm calls of its backward (dx with
    w a transposed view, dW with x one), and gmm_swiglu_bwd on the tensor
    cores, each against its plain version and called twice, bit-equal."""
    pcfg = train_mod.pad_experts(cfg, DIST_MESH[-1])
    e_loc = pcfg.moe.e_total // DIST_MESH[-1]
    C, D, Fe = dist_capacity(cfg), cfg.d_model, cfg.moe.d_expert
    rows = []
    for tag, name, C_, K, N, lay in (
            ("dist_ring", "gmm_swiglu", C, D, Fe, (0, 0)),
            ("dist_ring", "gmm", C, Fe, D, (0, 0)),
            ("dist_ring_bwd_dx", "gmm", C, D, Fe, (0, 1)),
            ("dist_ring_bwd_dw", "gmm", Fe, C, D, (1, 0))):
        r = kernel_case(name, e_loc, C_, K, N, torch.bfloat16, gen,
                        timed=False, layouts=lay, repeat=True)
        rows.append(dict(r, shape=tag))
    r = bwd_case(e_loc, C, D, Fe, torch.bfloat16, gen, timed=False)
    if r["body"] != "tensor_cores":
        raise AssertionError(f"phase 19's gmm_swiglu_bwd ran the FMA "
                             f"body: {r}")
    rows.append(dict(r, shape="dist_ring"))
    return rows


def dbrx_capacities():
    """dbrx-132b's expert capacity in phase 16: a decode step of the
    8-slot batch, a PROMPT_LEN-token prefill, and a training step of
    TRAIN_BATCH x TRAIN_SEQ tokens."""
    mc = get_config(DBRX).moe
    return {"dbrx_decode8": capacity(SLOTS, mc),
            "dbrx_prefill": capacity(PROMPT_LEN, mc),
            "dbrx_train": capacity(TRAIN_BATCH * TRAIN_SEQ, mc)}


def dbrx_kernel_rows(gen):
    """Phase 16 (d) and (e), run in phase 3: the kernels at dbrx-132b's
    widths (E = 16, K = 6144, F = 10752; a 4.2 GB w_in), each against its
    plain version, twice and bit-equal, and timed by device time beside
    its bound and, for gmm, ``torch.bmm``: the forward kernels at the
    serving and training capacities, gmm as the two calls of GMM2's
    backward (the views ``check_kernels`` names), and the backward kernel
    at the training capacity."""
    cfg = get_config(DBRX)
    E, D, Fe = cfg.moe.e_total, cfg.d_model, cfg.moe.d_expert
    caps = dbrx_capacities()
    C = caps["dbrx_train"]
    calls = [(tag, name, caps[tag], K, N, (0, 0))
             for tag in caps
             for name, (K, N) in (("gmm_swiglu", (D, Fe)),
                                  ("gmm", (Fe, D)))]
    calls += [("dbrx_train_bwd_dx", "gmm", C, D, Fe, (0, 1)),
              ("dbrx_train_bwd_dw", "gmm", Fe, C, D, (1, 0))]
    rows = []
    for tag, name, C_, K, N, lay in calls:
        r = kernel_case(name, E, C_, K, N, torch.bfloat16, gen,
                        timed="device", repeat=True, layouts=lay)
        rows.append(dict(r, shape=tag))
        torch.cuda.empty_cache()
    r = bwd_case(E, C, D, Fe, torch.bfloat16, gen, timed="device")
    if r["body"] != "tensor_cores":
        raise AssertionError(f"dbrx's gmm_swiglu_bwd ran the FMA body: {r}")
    rows.append(dict(r, shape="dbrx_train"))
    torch.cuda.empty_cache()
    return rows


def run_swiglu_add():
    """Phase 2b: the §6.1 SwiGLU + Add path. Returns the check rows, the
    benchmark's result and its launch counts."""
    checks = []
    for dname, dtype in bench_mod.DTYPES.items():
        for M, F in SWIGLU_ADD_CHECKS:
            h, y = bench_mod.inputs(M, F, dtype, "cuda", seed=M + F)
            for mode in bench_mod.MODES:
                checks.append({"kernel": f"swiglu_add_{mode}", "M": M,
                               "F": F, "dtype": dname,
                               "max_abs_err": bench_mod.check(mode, h, y),
                               "tol": bench_mod.TOL[dtype]})
            del h, y
    torch.cuda.synchronize()
    reset_launches()
    out = bench_mod.main(["--device", "cuda"])
    launches = read_launches()
    want = {k: 0 for k in COUNTERS}
    want.update(swiglu_add_serial=2 * out["calls"]["serial"],
                swiglu_add_interleaved=out["calls"]["interleaved"])
    if launches != want:
        raise AssertionError(f"swiglu_add launch counts {launches} != "
                             f"{want}: 2 per serial, 1 per interleaved call")
    rows = out["kernels"]
    if not all(math.isfinite(r["ms"]) and math.isfinite(r["plain_ms"])
               for r in rows):
        raise AssertionError(f"non-finite swiglu_add time: {rows}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return checks, out, launches


def plain_moe_impl(cfg):
    """The MoE block with the expert FFN's plain version (check only)."""
    def ffn(x, w_in, w_down, act):
        return moe_ffn_ref(x, w_in.to(x.dtype), w_down.to(x.dtype))
    return partial(moe_grouped, act=cfg.act, gmm_fn=ffn)


def run_slice(cfg):
    """Phase 4: the port's serving path at full width and depth."""
    t = time.perf_counter()
    params = M.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    rng = np.random.default_rng(0)
    prompts = {i: rng.integers(0, cfg.vocab, PROMPT_LEN)
               for i in range(REQUESTS)}
    max_len = PROMPT_LEN + MAX_NEW + 1

    # One prefill through the kernels against the plain expert FFN.
    toks = torch.as_tensor(prompts[0][None, :], device="cuda")
    with torch.inference_mode():
        lk, _ = M.prefill(cfg, params, {"tokens": toks}, max_len)
        lp, _ = M.prefill(cfg, params, {"tokens": toks}, max_len,
                          moe_impl=plain_moe_impl(cfg))
    lk, lp = lk.float(), lp.float()
    if not (bool(torch.isfinite(lk).all()) and bool(torch.isfinite(lp).all())):
        raise AssertionError("non-finite prefill logits")
    logit_err = float((lk - lp).abs().max())
    logit_scale = float(lp.abs().max())
    if logit_err > LOGIT_TOL * logit_scale:
        raise AssertionError(f"kernel-backed prefill logits differ from the "
                             f"plain path: {logit_err} > {LOGIT_TOL} x "
                             f"{logit_scale}")

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with torch.inference_mode():
        b, stats = serve_mod.serve(cfg, params, prompts, n_slots=SLOTS,
                                   max_new=MAX_NEW, device="cuda")
    launches = read_launches()
    want = cfg.n_layers * (stats["prefills"] + stats["decode_steps"])
    if stats["requests"] != REQUESTS:
        raise AssertionError(f"served {stats['requests']} of {REQUESTS}")
    if any(len(b.generated[r]) != MAX_NEW for r in prompts):
        raise AssertionError("a request has the wrong number of tokens")
    if stats["nonfinite_steps"]:
        raise AssertionError(f"{stats['nonfinite_steps']} steps had "
                             f"non-finite logits")
    if launches != dict({k: 0 for k in COUNTERS}, gmm_swiglu=want, gmm=want):
        raise AssertionError(f"launch counts {launches} != {want} = "
                             f"{cfg.n_layers} x (prefills + decode steps)")
    out = {"phase": "slice", "arch": cfg.name, "dtype": cfg.dtype,
           "n_layers": cfg.n_layers, "params": cfg.param_count(),
           "init_s": init_s, "slots": SLOTS, "prompt_len": PROMPT_LEN,
           "max_new": MAX_NEW, "logit_max_abs_err": logit_err,
           "logit_max_abs": logit_scale, "logit_tol": LOGIT_TOL,
           "top1_agree": bool(lk.argmax() == lp.argmax()),
           "launches": launches, "expected_launches": want,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    out.update(stats)
    return out, launches


def plain_train_impl(cfg):
    """The MoE block with autograd through the plain expert FFN (check
    only)."""
    def ffn(x, w_in, w_down, act):
        return moe_ffn_ref(x, w_in.to(x.dtype), w_down.to(x.dtype))
    return partial(moe_grouped, act=cfg.act, gmm_fn=ffn)


def train_batch(cfg, step=0):
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH))
    return stream.batch(step, "cuda")


def run_train_parity(cfg):
    """Phase 5: one 4096-token batch's loss and grads at full width on
    PARITY_LAYERS layers, through the kernels and through the plain FFN."""
    pcfg = dataclasses.replace(cfg, n_layers=PARITY_LAYERS)
    params = adamw.cast_params(M.init_params(
        pcfg, torch.Generator(device="cuda").manual_seed(0), device="cuda"),
        pcfg.compute_dtype)
    batch = train_batch(pcfg)
    lk, gk = steps_mod.value_and_grad(pcfg, params, batch)
    lp, gp = steps_mod.value_and_grad(pcfg, params, batch,
                                      moe_impl=plain_train_impl(pcfg))
    lk, lp = float(lk), float(lp)
    if not (math.isfinite(lk) and math.isfinite(lp)):
        raise AssertionError(f"non-finite parity losses {lk}, {lp}")
    loss_gap = abs(lk - lp) / abs(lp)
    gaps = [abs(float(a.float().norm()) - float(b.float().norm()))
            / max(float(b.float().norm()), 1e-30)
            for a, b in zip(adamw.tree_leaves(gk), adamw.tree_leaves(gp))]
    out = {"phase": "train_parity", "n_layers": PARITY_LAYERS,
           "tokens": TRAIN_BATCH * TRAIN_SEQ, "loss_kernels": lk,
           "loss_plain": lp, "loss_rel_gap": loss_gap, "loss_tol": LOSS_TOL,
           "grad_leaves": len(gaps), "grad_norm_rel_gap_max": max(gaps),
           "grad_norm_rel_gap_median": statistics.median(gaps),
           "grad_norm_tol": GNORM_TOL}
    if loss_gap > LOSS_TOL or max(gaps) > GNORM_TOL:
        raise AssertionError(f"kernel train step differs from the plain "
                             f"FFN's: {out}")
    return out


def run_train(cfg, rows):
    """Phase 6: ``launch.train`` at full width and depth on one card."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t = time.perf_counter()
    run = train_mod.main(["--arch", ARCH, "--seq", str(TRAIN_SEQ),
                          "--global-batch", str(TRAIN_BATCH),
                          "--steps", str(TRAIN_STEPS)])
    wall = time.perf_counter() - t
    launches = read_launches()
    bwd_tc = bwd_mod.launches_tc
    log = run.metrics_log
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in log):
        raise AssertionError(f"non-finite training metrics: {log}")
    per_step = {k: cfg.n_layers * TRAIN_STEPS * n
                for k, n in TRAIN_LAUNCHES.items()}
    if launches != per_step:
        raise AssertionError(f"training launch counts {launches} != "
                             f"{per_step} = {cfg.n_layers} layers x "
                             f"{TRAIN_STEPS} steps x {TRAIN_LAUNCHES}")
    if bwd_tc != per_step["gmm_swiglu_bwd"]:
        raise AssertionError(f"{bwd_tc} of {per_step['gmm_swiglu_bwd']} "
                             f"gmm_swiglu_bwd calls ran the tensor-core "
                             f"body")
    step_ms = statistics.median(m["step_ms"] for m in log[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # Where a step's time goes: each kernel's measured time at the training
    # shape x its launches per step; the rest is plain ops and host time.
    by_shape = {(r["kernel"], r.get("shape")): r["ms"] for r in rows
                if r.get("shape", "").startswith("train") and "ms" in r}
    L = cfg.n_layers
    kernel_ms = {
        "gmm_swiglu": 2 * L * by_shape[("gmm_swiglu", "train")],
        "gmm (forward, recompute)": 2 * L * by_shape[("gmm", "train")],
        "gmm (backward dx)": L * by_shape[("gmm", "train_bwd_dx")],
        "gmm (backward dw)": L * by_shape[("gmm", "train_bwd_dw")],
        "gmm_swiglu_bwd": L * by_shape[("gmm_swiglu_bwd", "train")],
    }
    out = {"phase": "train", "arch": cfg.name, "dtype": cfg.dtype,
           "n_layers": cfg.n_layers, "remat": cfg.remat,
           "params": cfg.param_count(), "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "capacity": capacity(tokens, cfg.moe),
           "steps": TRAIN_STEPS, "wall_s": wall,
           "losses": [m["loss"] for m in log],
           "grad_norms": [m["grad_norm"] for m in log],
           "step_ms": [m["step_ms"] for m in log],
           "step_ms_median_after_warmup": step_ms,
           "tokens_per_s": tokens / (step_ms / 1e3),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "expected_launches": per_step,
           "gmm_swiglu_bwd_tensor_core_launches": bwd_tc,
           "step_breakdown_ms": dict(
               kernel_ms, rest=step_ms - sum(kernel_ms.values()))}
    del run
    torch.cuda.empty_cache()
    return out, launches


def first_tiled(E, N) -> int:
    """The fewest rows of an fp32 ``gmm`` call of E experts and N columns
    that the tiled body takes: ``gmm.FP32_TILED_MIN_ROWS``, or fewer where
    its 32 x 64 tile's grid reaches ``gmm.FP32_TILED_MIN_CTAS`` CTAs."""
    most = gmm_mod.FP32_TILED_MIN_ROWS
    return next(C for C in range(1, most + 1) if C == most or E * -(-C // 32)
                * -(-N // 64) >= gmm_mod.FP32_TILED_MIN_CTAS)


def check_fp32_bodies(rows) -> dict:
    """The dropless tiles' body check on their ``kernel_case`` rows: the
    checked call of each row grew ``gmm.launches_fp32_tiled`` and
    ``launches_fp32_narrow`` by one if the row names that body and by none
    if not; each of the six dropless tile calls (shape ``dropless_tile``)
    names the tiled body from ``first_tiled(1, N)`` rows of its own (C) on
    and the narrow body below (their widths and bases are TMA's). A tile of
    one row makes the weight gradients' x a [1536, 1] view that reads as
    contiguous, K = 1 floats wide: the small-row body's by the rule.
    Returns the tiled and narrow launches of the checked calls; raises
    AssertionError naming the rows at fault."""
    def want(r):
        if r["K"] == 1:
            return "small"
        return "tiled" if r["C"] >= first_tiled(1, r["N"]) else "narrow"
    bad = [r for r in rows
           if r["tiled_launches"] != (r["body"] == "tiled")
           or r["narrow_launches"] != (r["body"] == "narrow")
           or (r["shape"] == "dropless_tile" and r["body"] != want(r))]
    if bad:
        raise AssertionError(f"gmm's fp32 calls ran the wrong body: {bad}")
    return {body: sum(r[f"{body}_launches"] for r in rows)
            for body in ("tiled", "narrow")}


def run_dropless_tiles(cfg):
    """Phase 7: ``gmm`` at the dropless tiles' calls, fp32, E = 1: GMM1 and
    GMM2 (x·W), their activation gradients (x·Wᵀ, w a transposed view) and
    their weight gradients (xᵀ·dy, x a transposed view, summing over the
    rows); then the fp32 bodies' edges (DROPLESS_EDGES). Each row names
    its body; ``check_fp32_bodies`` holds them to the rule."""
    D, F2, Fe = cfg.d_model, 2 * cfg.moe.d_expert, cfg.moe.d_expert
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for C in DROPLESS_ROWS:
        for tile, c, K, N, lay in (
                ("gmm1", C, D, F2, (0, 0)), ("gmm2", C, Fe, D, (0, 0)),
                ("gmm1_act_grad", C, F2, D, (0, 1)),
                ("gmm2_act_grad", C, D, Fe, (0, 1)),
                ("gmm1_wgrad", D, C, F2, (1, 0)),
                ("gmm2_wgrad", Fe, C, D, (1, 0))):
            r = kernel_case("gmm", 1, c, K, N, torch.float32, gen,
                            timed=C == DROPLESS_TIMED_ROWS, layouts=lay,
                            repeat=True)
            r.update(shape="dropless_tile", tile=tile, rows=C)
            rows.append(r)
    for C, K, N, lay in DROPLESS_EDGES:
        r = kernel_case("gmm", 3, C, K, N, torch.float32, gen, timed=False,
                        layouts=lay, repeat=True)
        r["shape"] = "dropless_edge"
        rows.append(r)
    return rows, check_fp32_bodies(rows)


def row_count_bits(cfg):
    """fp32 ``gmm`` at E = 1 and both GMM widths (GMM1 K/N = d/2F, GMM2
    F/d): for every C from 1 to ROW_BITS_MAX, the rows of
    ``gmm(x[:, :C], w)`` must be bit-equal to ``gmm(x, w)[:, :C]`` at C =
    ROW_BITS_MAX, across the narrow and the tiled body (each output one
    ascending-k fmaf chain), and the bodies must be the rule's: narrow
    under ``first_tiled(1, N)`` rows, tiled from there. A bucket ladder
    that pads a tile's rows then cannot change a served token. Raises
    naming the row counts at fault."""
    D, F2, Fe = cfg.d_model, 2 * cfg.moe.d_expert, cfg.moe.d_expert
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = []
    for tile, K, N in (("gmm1", D, F2), ("gmm2", Fe, D)):
        x = torch.randn((1, ROW_BITS_MAX, K), generator=gen, device="cuda")
        w = torch.randn((1, K, N), generator=gen, device="cuda") * K ** -0.5
        full = gmm_mod.gmm(x, w)
        err = float((full - gmm_ref(x, w)).abs().max())
        bodies, bad = {}, []
        for C in range(1, ROW_BITS_MAX + 1):
            xc = x[:, :C]
            bodies.setdefault(gmm_mod.fp32_body(xc, w), []).append(C)
            if not torch.equal(gmm_mod.gmm(xc, w), full[:, :C]):
                bad.append(C)
        row = {"tile": tile, "K": K, "N": N, "rows": [1, ROW_BITS_MAX],
               "bodies": {b: [min(c), max(c)] for b, c in bodies.items()},
               "rows_not_bit_equal": bad, "max_abs_err": err}
        b = first_tiled(1, N)
        want = {"narrow": [1, b - 1], "tiled": [b, ROW_BITS_MAX]}
        if bad or row["bodies"] != want or err > TOL[torch.float32]:
            raise AssertionError(f"fp32 gmm's rows depend on the call's "
                                 f"row count: {row}")
        row["timed"] = []
        for C in DECODE_TILE_ROWS:
            xc = x[:, :C]
            b_ms, b_by = bound(1, C, K, N, False, torch.float32)
            row["timed"].append({
                "C": C, "body": gmm_mod.fp32_body(xc, w),
                "ms": cuda_ms(lambda: gmm_mod.gmm(xc, w)),
                "plain_ms": cuda_ms(lambda: gmm_ref(xc, w)),
                "library_ms": cuda_ms(lambda: torch.bmm(xc, w)),
                "bound_ms": b_ms, "bound_by": b_by})
        out.append(row)
    return out

def run_dropless_fragment():
    """Phase 8: one full-width layer's dropless fragment, checked and timed
    by ``launch.bench_dropless`` at ep = 1 and 4."""
    out = dropless_bench.main(["--device", "cuda"])
    for r in out["rows"]:
        if not (r["gmm_launches_forward"] > 0
                and r["gmm_launches_backward"] > 0):
            raise AssertionError(f"the dropless fragment ran no gmm: {r}")
        if not all(math.isfinite(r[k]) for k in (
                "forward_ms", "backward_ms", "compile_forward_ms",
                "compile_backward_ms")):
            raise AssertionError(f"non-finite dropless time: {r}")
    torch.cuda.empty_cache()
    return {"phase": "dropless_fragment",
            "note": "ep = 4 is four virtual ranks on one card; their puts "
                    "are device copies, not a collective",
            **out}


def check_dropless_lookups(log, n_layers):
    """Each dropless step's SSC lookups, ``ssc_hits + ssc_misses``: one
    forward and one backward schedule per layer, 2 x ``n_layers``, and no
    hit. A remat that re-ran the fragment's forward would add one hit per
    layer. Returns the per-step counts; raises otherwise."""
    counts = [int(m["ssc_hits"] + m["ssc_misses"]) for m in log]
    hits = [int(m["ssc_hits"]) for m in log]
    if any(n != 2 * n_layers for n in counts) or any(hits):
        raise AssertionError(
            f"dropless SSC lookups per step {counts} (hits {hits}): want "
            f"{2 * n_layers} misses and no hit, one fragment forward and "
            f"backward per layer")
    return counts


def run_dropless_train(cfg):
    """Phase 9: 2-layer dropless parity with the fixed-capacity step, then
    ``launch.train --dropless`` at full width and depth."""
    # top-k picks an expert at most once per token, so C = T drops nothing:
    # capacity_factor = e_total / top_k gives C = T.
    mc = cfg.moe
    pcfg = dataclasses.replace(
        cfg, n_layers=PARITY_LAYERS, moe=dataclasses.replace(
            mc, capacity_factor=mc.e_total / mc.top_k))
    params = adamw.cast_params(M.init_params(
        pcfg, torch.Generator(device="cuda").manual_seed(0), device="cuda"),
        pcfg.compute_dtype)
    batch = train_batch(pcfg)
    dm = dropless_mod.DroplessMoE(dropless_mod.DroplessConfig(),
                                  cache=SSCCache())
    ld, gd = steps_mod.value_and_grad(pcfg, params, batch, moe_impl=dm.impl)
    lf, gf = steps_mod.value_and_grad(pcfg, params, batch)
    ld, lf = float(ld), float(lf)
    if not (math.isfinite(ld) and math.isfinite(lf)):
        raise AssertionError(f"non-finite dropless parity losses {ld}, {lf}")
    loss_gap = abs(ld - lf) / abs(lf)
    gaps = [abs(float(a.float().norm()) - float(b.float().norm()))
            / max(float(b.float().norm()), 1e-30)
            for a, b in zip(adamw.tree_leaves(gd), adamw.tree_leaves(gf))]
    parity = {"n_layers": PARITY_LAYERS, "tokens": TRAIN_BATCH * TRAIN_SEQ,
              "fixed_capacity": capacity(TRAIN_BATCH * TRAIN_SEQ,
                                         pcfg.moe),
              "loss_dropless": ld, "loss_fixed": lf, "loss_rel_gap": loss_gap,
              "loss_tol": LOSS_TOL, "grad_leaves": len(gaps),
              "grad_norm_rel_gap_max": max(gaps),
              "grad_norm_rel_gap_median": statistics.median(gaps),
              "grad_norm_tol": GNORM_TOL,
              "ssc_misses": dm.cache.info()["misses"]}
    if loss_gap > LOSS_TOL or max(gaps) > GNORM_TOL:
        raise AssertionError(f"dropless train step differs from the "
                             f"fixed-capacity step: {parity}")
    del params, gd, gf, dm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    t = time.perf_counter()
    run = train_mod.main(["--arch", ARCH, "--seq", str(TRAIN_SEQ),
                          "--global-batch", str(TRAIN_BATCH),
                          "--steps", str(DROPLESS_STEPS), "--dropless"])
    wall = time.perf_counter() - t
    launches = read_launches()
    tiled = gmm_mod.launches_fp32_tiled
    narrow = gmm_mod.launches_fp32_narrow
    log = run.metrics_log
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in log):
        raise AssertionError(f"non-finite dropless training metrics: {log}")
    if launches["gmm"] == 0 or any(v for k, v in launches.items()
                                   if k != "gmm"):
        raise AssertionError(f"dropless training launches {launches}: gmm "
                             f"only, at least once")
    if tiled == 0:
        raise AssertionError("dropless training never ran gmm's fp32 tiled "
                             "body")
    lookups = check_dropless_lookups(log, cfg.n_layers)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_ms = statistics.median(m["step_ms"] for m in log[1:])
    out = {"phase": "dropless_train", "parity": parity, "arch": cfg.name,
           "dtype": cfg.dtype, "n_layers": cfg.n_layers, "remat": cfg.remat,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": DROPLESS_STEPS,
           "dropless": dataclasses.asdict(run.dropless.dc), "wall_s": wall,
           "per_step": [dict(m, tokens_per_s=tokens / (m["step_ms"] / 1e3))
                        for m in log],
           "step_ms_median_after_warmup": step_ms,
           "tokens_per_s": tokens / (step_ms / 1e3),
           "max_memory_allocated_bytes": max(m["peak_bytes"] for m in log),
           "launches": launches, "gmm_fp32_tiled_launches": tiled,
           "gmm_fp32_narrow_launches": narrow,
           "ssc_lookups_per_step": lookups,
           "whole_block_checkpoint": WHOLE_BLOCK_CHECKPOINT,
           "cache": {k: v for k, v in run.dropless.cache.info().items()
                     if k != "per_entry"}}
    del run
    torch.cuda.empty_cache()
    return out, launches


def run_fused_dropless(argv=("--device", "cuda")):
    """Phase 10: ``launch.bench_fused_dropless`` (checks, then times on the
    card). Its checks raise on a mismatch; here the card's rows must show
    ``gmm`` launches and finite times."""
    out = fused_bench.main(list(argv))
    for r in out["rows"]:
        if "fused" not in r:
            continue                     # no times off the card
        for tag in ("fused", "sequential"):
            t = r[tag]
            if not (t["gmm_launches_forward"] > 0
                    and t["gmm_launches_backward"] > 0):
                raise AssertionError(f"the {tag} block ran no gmm: {t}")
            if not all(math.isfinite(t[k]) for k in (
                    "forward_ms", "backward_ms", "forward_busy_ms",
                    "backward_busy_ms", "compile_forward_ms",
                    "compile_backward_ms")):
                raise AssertionError(f"non-finite fused dropless time: {t}")
    return {"phase": "fused_dropless",
            "note": "ep = 4 is four virtual ranks on one card; their puts "
                    "are device copies, not a collective",
            **out}


def routed_cfgs(cfg, tokens, ep, n, seed, dev):
    """``n`` dropless schedule configs at ``ep``, each planned (bucket
    ``linear:16``) from ``tokens`` standard normals by its own router."""
    mc = cfg.moe
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((tokens, cfg.d_model), generator=gen, device=dev)
    dc = dropless_mod.DroplessConfig(ep=ep)
    out = []
    for _ in range(n):
        router = init_moe(gen, cfg.d_model, mc)["router"]
        ti = router_topk(router, x, mc)[1].cpu().numpy()
        plan = dropless_mod._bridge_of(dc, ti, mc).plan
        out.append(dropless_mod._schedule_cfg(dc, plan, cfg.d_model,
                                              mc.d_expert))
    return out


def stage_matrices(plans, rng, dev):
    """One map per junction (stage s to s+1) per rank: rows of stage s+1's
    send layout from rows of stage s's, standard normals — the reference's
    PP tests' maps (``tests/test_pp_fusion.py``), on ``dev``."""
    return [{r: torch.from_numpy(rng.standard_normal(
                (plans[s + 1].send_rows(r), plans[s].send_rows(r)))
                .astype(np.float32)).to(dev)
             for r in range(plans[0].ep)}
            for s in range(len(plans) - 1)]


def pp_boundary_fns(fs, mats, d, transpose=False):
    """The PP-fused schedule's boundary fns: physical junction
    ``m*(S-1) + s`` applies stage s's map (transposed for the backward).
    Each (junction, rank) product is made once and sliced per tile."""
    pp = fs.opts["pp"]
    S, M = pp["n_stages"], pp["n_microbatches"]
    fns = {}
    for m in range(M):
        for s in range(S - 1):
            for r, A in mats[s].items():
                A = A.T if transpose else A

                def fn(data, lo, hi, A=A, _memo={}):
                    if "out" not in _memo:
                        if data is None:
                            data = A.new_zeros((A.shape[1], d))
                        _memo["out"] = A @ data
                    return _memo["out"][lo:hi]
                fns[(m * (S - 1) + s, r)] = fn
    return fns


def pp_fused_case(cfg, tokens=PP_TOKENS, ep=PP_EP, n_stages=PP_STAGES,
                  n_micro=PP_MICROBATCHES, dev="cuda", seed=0):
    """Phase 11's check: the PP-fused taskflow (StageBoundary tiles) through
    the executor, forward and backward, bit-equal to the cells run one by
    one (``reference_forward_plan`` / ``reference_backward_plan`` through
    the same ``gmm``, the stage maps applied between them). Returns the
    schedule's sizes, the executor's ``gmm`` launches and its host ms."""
    dev = torch.device(dev)
    d, S, M = cfg.d_model, n_stages, n_micro
    cfgs = routed_cfgs(cfg, tokens, ep, S, seed, dev)
    plans = [c.routing for c in cfgs]
    rng = np.random.default_rng(seed)
    mats = stage_matrices(plans, rng, dev)
    ws = [ex.make_inputs_plan(c, seed + 13 * i, dev)[1:]
          for i, c in enumerate(cfgs)]
    x_srcs = [[torch.from_numpy(rng.standard_normal(
                  (plans[0].send_rows(r), d)).astype(np.float32)).to(dev)
               for r in range(ep)] for _ in range(M)]
    refs = []                            # refs[m][s]
    for m in range(M):
        cur, per_m = x_srcs[m], []
        for s in range(S):
            per_m.append(ex.reference_forward_plan(cfgs[s], cur, *ws[s]))
            if s < S - 1:
                cur = [mats[s][r] @ per_m[s]["y_ret"][r] for r in range(ep)]
        refs.append(per_m)
    dys = [[torch.from_numpy(rng.standard_normal(
               tuple(refs[m][S - 1]["y_ret"][r].shape)).astype(np.float32))
            .to(dev) for r in range(ep)] for m in range(M)]
    brefs = []                           # brefs[m][s] = (dx, dw1, dw2)
    for m in range(M):
        per_m, dy = [None] * S, dys[m]
        for s in range(S - 1, -1, -1):
            per_m[s] = ex.reference_backward_plan(cfgs[s], refs[m][s],
                                                  *ws[s], dy)
            if s > 0:
                dy = [mats[s - 1][r].T @ per_m[s][0][r] for r in range(ep)]
        brefs.append(per_m)

    out = {"n_stages": S, "n_microbatches": M, "ep": ep, "tokens": tokens,
           "d_model": d, "d_ff": cfg.moe.d_expert,
           "send_rows": [[p.send_rows(r) for r in range(ep)]
                         for p in plans]}
    w1s, w2s = [w[0] for w in ws], [w[1] for w in ws]
    for direction, pipe in (("forward", ("ratr",)),
                            ("backward", ("ratr", "gmm_interleave"))):
        t = time.perf_counter()
        fs = fu.compile_pp_fused(cfgs, M, direction=direction,
                                 pipeline=pipe)
        compile_ms = 1e3 * (time.perf_counter() - t)
        st = ex.ExecutorState(cfgs[0] if direction == "forward"
                              else cfgs[-1], dev,
                              fragment_cfgs=fu.pp_fragment_cfgs(fs, cfgs))
        if direction == "forward":
            fu.load_pp_forward_state(fs, cfgs, st, x_srcs, w1s, w2s)
        else:
            fu.load_pp_backward_state(fs, cfgs, st, dys, refs, w1s, w2s)
        st.boundary_fns = pp_boundary_fns(fs, mats, d,
                                          transpose=direction == "backward")
        before = gmm_mod.launches
        t = time.perf_counter()
        ex.execute(fs, st, rng=np.random.default_rng(seed))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        walk_ms = 1e3 * (time.perf_counter() - t)
        n_bnd = sum(td.task_type == "StageBoundary" for td in fs.tasks)
        if not n_bnd:
            raise AssertionError("pp_fused: no StageBoundary tile")
        for m in range(M):
            for s in range(S):
                lab = f"S{s}M{m}"
                for r in range(ep):
                    pairs = []
                    if direction == "forward" and plans[s].send_rows(r):
                        pairs.append((f"y_ret#{lab}",
                                      refs[m][s]["y_ret"][r]))
                    if direction == "backward":
                        dx, dw1, dw2 = brefs[m][s]
                        if plans[s].send_rows(r):
                            pairs.append((f"dx_ret#{lab}", dx[r]))
                        if plans[s].recv_rows(r):
                            pairs += [(f"dW1#{lab}", dw1[r]),
                                      (f"dW2#{lab}", dw2[r])]
                    for name, want in pairs:
                        if not torch.equal(st.get(name, r), want):
                            raise AssertionError(
                                f"pp_fused {direction}: {name} rank {r} "
                                f"differs from the cells run one by one")
        out[direction] = {"tasks": fs.n_tasks, "fragments": fs.n_fragments,
                          "stage_boundary_tiles": n_bnd,
                          "compile_ms": compile_ms, "walk_ms": walk_ms,
                          "gmm_launches": gmm_mod.launches - before,
                          "bit_equal_cells": True}
    return out


def run_pp_fused(cfg):
    """Phase 11 on the card."""
    out = pp_fused_case(cfg)
    for direction in ("forward", "backward"):
        if out[direction]["gmm_launches"] == 0:
            raise AssertionError(f"pp_fused {direction} ran no gmm")
    torch.cuda.empty_cache()
    return {"phase": "pp_fused",
            "note": "ep = 4 is four virtual ranks on one card", **out}


def elastic_case(cfg, tokens=TRAIN_SEQ, ep=ELASTIC_EP, dead=ELASTIC_DEAD,
                 dev="cuda", seed=0):
    """Phase 12's checks: the rescaled handle against a native one, and the
    remapped plan's survivors against the ep-rank run, bit for bit."""
    dev = torch.device(dev)
    mc, d, F = cfg.moe, cfg.d_model, cfg.moe.d_expert
    params, x = dropless_bench.layer(cfg, tokens, seed, dev)
    survivors = elastic.surviving_ranks(ep, dead)
    big = dropless_mod.DroplessMoE(dropless_mod.DroplessConfig(ep=ep),
                                   cache=SSCCache())
    small = big.rescale(dead_ranks=list(dead))
    native = dropless_mod.DroplessMoE(
        dropless_mod.DroplessConfig(ep=len(survivors)), cache=SSCCache())
    info = big.cache.info()
    if not (small.cache is big.cache and small.dc == native.dc
            and info["active_ep"] == len(survivors)):
        raise AssertionError(f"elastic: rescale gave {small.dc}, cache "
                             f"{info['active_ep']}")
    g = torch.randn(tuple(x.shape), generator=torch.Generator(
        device=dev).manual_seed(7), device=dev)
    got = {}
    for name, h in (("rescaled", small), ("native", native)):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        xx = x.detach().clone().requires_grad_(True)
        y = h.impl(p, xx, mc)
        y.backward(g)
        got[name] = [y.detach(), xx.grad] + [p[k].grad for k in sorted(p)]
    if not all(torch.equal(a, b) for a, b in zip(*got.values())):
        raise AssertionError("elastic: the rescaled handle differs from a "
                             "native one")

    # The routed ep-rank plan, remapped onto the survivors.
    T = tokens
    xt = x.reshape(T, d)
    ti = router_topk(params["router"], xt, mc)[1].cpu().numpy()
    dc = dropless_mod.DroplessConfig(ep=ep)
    bridge = dropless_mod._bridge_of(dc, ti, mc)
    cfg_big = dropless_mod._schedule_cfg(dc, bridge.plan, d, F)
    plan_small = elastic.remap_plan(bridge.plan, dead_ranks=dead)
    report = elastic.check_remap(bridge.plan, plan_small, survivors)
    if not report["ok"]:
        raise AssertionError(f"elastic: remap invariants {report}")
    cfg_small = dropless_mod._schedule_cfg(
        dataclasses.replace(dc, ep=len(survivors)), plan_small, d, F)
    x_src = bridge_dispatch(bridge, xt.reshape(ep, T // ep, d))
    w1, w2 = dropless_mod._expert_weights(dc, mc, params["w_in"],
                                          params["w_down"])
    pipe = dc.pipeline_spec()
    st_big = ex.ExecutorState(cfg_big, dev)
    ex.load_forward_state_plan(cfg_big, st_big, x_src, w1, w2)
    ex.execute(big.cache.get_or_compile(cfg_big, "forward", pipeline=pipe),
               st_big, rng=np.random.default_rng(0))
    misses = big.cache.misses
    t = time.perf_counter()
    sched = big.cache.get_or_compile(cfg_small, "forward", pipeline=pipe)
    compile_ms = 1e3 * (time.perf_counter() - t)
    missed = big.cache.misses > misses
    st = ex.ExecutorState(cfg_small, dev)
    ex.load_forward_state_plan(
        cfg_small, st, [x_src[r] for r in survivors],
        elastic.rechunk_expert_array(w1, len(survivors), e_total=mc.e_total),
        elastic.rechunk_expert_array(w2, len(survivors), e_total=mc.e_total))
    ex.execute(sched, st, rng=np.random.default_rng(0))
    for i, r in enumerate(survivors):
        if plan_small.send_rows(i) and not torch.equal(
                st.get("y_ret", i), st_big.get("y_ret", r)):
            raise AssertionError(f"elastic: survivor {r}'s y_ret differs "
                                 f"from the ep = {ep} run's")
    info = big.cache.info()
    return {"ep": ep, "dead_ranks": list(dead), "survivors": list(survivors),
            "tokens": T, "remap": report, "rescaled_equals_native": True,
            "survivors_y_ret_bit_equal": True,
            "compile_after_rekey_ms": compile_ms,
            "compile_after_rekey_was_a_miss": missed,
            "cache": {k: info[k] for k in ("entries", "hits", "misses",
                                           "rekeyed", "active_ep",
                                           "by_ep")}}


def run_elastic(cfg):
    """Phase 12 on the card."""
    out = elastic_case(cfg)
    torch.cuda.empty_cache()
    return {"phase": "elastic", **out}


def fragment_bits_case(cfg, tokens=SLOTS, ep=None, dev="cuda", seed=0):
    """Phase 13's fragment check: one full-width MoE layer (fp32, its own
    router, from ``seed``) on a decode-sized batch of ``tokens`` tokens
    (tokens x top-k routed rows), at the serving ep. Its output under
    ``exact``, ``linear:4`` and the ladder fitted on the decode population
    (``serve --online-refit``'s seed spec) must be bit-equal on the card,
    and each is checked by ``bench_dropless.check`` (within 1e-5 of the
    plain executor, the fixed-capacity layer, the grads). The specs must
    pad the plan to different row counts, or the check would be empty."""
    dev = torch.device(dev)
    mc = cfg.moe
    ep = ep or serve_mod.serving_ep(mc, tokens, PROMPT_LEN)
    params, x = dropless_bench.layer(cfg, tokens, seed, dev)
    ti = router_topk(params["router"], x.reshape(tokens, -1), mc)[1]
    ti = ti.cpu().numpy()
    specs = {"exact": "exact", "linear:4": "linear:4",
             "fitted": fit_ladder(serve_mod.decode_population(
                 mc, ep, tokens), 6, 1.0)}
    ys, rows, checks = {}, {}, {}
    for name, spec in specs.items():
        dc = dropless_mod.DroplessConfig(ep=ep, bucket=spec,
                                         pipeline=("ratr",))
        checks[name] = dropless_bench.check(params, x, mc, dc)
        with torch.no_grad():
            ys[name] = dropless_mod.DroplessMoE(
                dc, cache=SSCCache()).impl(params, x, mc)
        rows[name] = plan_from_routing(ti, mc, ep, capacity=None,
                                       bucket=spec).plan.total_rows
    gap = max(float((y - ys["exact"]).abs().max()) for y in ys.values())
    out = {"tokens": tokens, "ep": ep, "routed_rows": int(ti.size),
           "plan_rows": rows, "specs": {k: str(fit) if k == "fitted" else k
                                        for k, fit in specs.items()},
           "bit_equal": gap == 0.0, "max_gap": gap, "checks": checks}
    if len(set(rows.values())) < 2:
        raise AssertionError(f"serve_online: the specs pad alike {rows}")
    if dev.type == "cuda" and not out["bit_equal"]:
        raise AssertionError(f"serve_online: the fragment's output moves "
                             f"with the bucket spec: {out}")
    return out


def forced_swap_case(cfg, n_layers=SWAP_LAYERS, requests=SLOTS,
                     prompt_len=PROMPT_LEN, max_new=MAX_NEW_SWAP,
                     swap_at=SWAP_AT, dev="cuda"):
    """Phase 13's swap check: the model cut to ``n_layers`` (full width, the
    config's dtype) serves ``requests`` requests through ``OnlineMoE``
    twice, once unswapped and once with ``swap_to("linear:4")`` forced
    before decode step ``swap_at``: the greedy tokens must be identical
    (the reference's serving-stack contract)."""
    dev = torch.device(dev)
    pcfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = M.init_params(pcfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    rng = np.random.default_rng(0)
    prompts = {i: rng.integers(0, cfg.vocab, prompt_len)
               for i in range(requests)}
    ep = serve_mod.serving_ep(cfg.moe, SLOTS, prompt_len)
    counts = serve_mod.decode_population(cfg.moe, ep, SLOTS)

    def run(swap):
        om = serve_mod.make_online_moe(pcfg, ep, counts, cache=SSCCache())
        b = serve_mod.ContinuousBatcher(
            pcfg, params, n_slots=SLOTS, max_len=prompt_len + max_new + 1,
            moe_impl=om.impl, device=dev)
        pending, finished, steps = list(prompts), [], 0
        with torch.inference_mode():
            while pending or b.active.any() or b.instant_done:
                while pending and b.admit(pending[0], prompts[pending[0]],
                                          max_new):
                    pending.pop(0)
                if swap and steps == swap_at:
                    om.swap_to("linear:4")
                finished += b.step()
                steps += 1
        if sorted(finished) != sorted(prompts):
            raise AssertionError("serve_online: a request did not finish")
        return b.generated, om
    plain, _ = run(False)
    swapped, om = run(True)
    forced = [e for e in om.tuner.swaps if e.get("forced")]
    out = {"n_layers": n_layers, "requests": requests, "max_new": max_new,
           "swap_at": swap_at, "forced_swaps": len(forced),
           "tokens_identical": swapped == plain,
           "tuner": om.tuner.summary()}
    if not forced or swapped != plain:
        raise AssertionError(f"serve_online: a forced swap changed the "
                             f"served tokens: {out}")
    return out


def online_prefill_case(cfg, dev="cuda"):
    """Phase 13's prefill check: the first request's prefill (the
    full-depth run's own params and prompt) through ``OnlineMoE`` against
    the plain expert FFN at a capacity that drops nothing, within phase
    4's LOGIT_TOL x max|logit|."""
    dev = torch.device(dev)
    mc = cfg.moe
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, PROMPT_LEN)
    toks = torch.as_tensor(prompt[None, :], device=dev)
    ep = serve_mod.serving_ep(mc, SLOTS, PROMPT_LEN)
    om = serve_mod.make_online_moe(
        cfg, ep, serve_mod.decode_population(mc, ep, SLOTS),
        cache=SSCCache())
    pcfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        mc, capacity_factor=mc.e_total / mc.top_k))
    max_len = PROMPT_LEN + MAX_NEW + 1
    with torch.inference_mode():
        lo, _ = M.prefill(cfg, params, {"tokens": toks}, max_len,
                          moe_impl=om.impl)
        lp, _ = M.prefill(pcfg, params, {"tokens": toks}, max_len,
                          moe_impl=plain_moe_impl(pcfg))
    lo, lp = lo.float(), lp.float()
    err, scale = float((lo - lp).abs().max()), float(lp.abs().max())
    out = {"logit_max_abs_err": err, "logit_max_abs": scale,
           "logit_tol": LOGIT_TOL, "top1_agree": bool(
               lo.argmax() == lp.argmax()),
           "finite": bool(torch.isfinite(lo).all())}
    if not out["finite"] or err > LOGIT_TOL * scale:
        raise AssertionError(f"serve_online: the online prefill differs "
                             f"from the plain FFN: {out}")
    return out


def run_serve_online(cfg, fixed):
    """Phase 13: the checks, then ``launch.serve.main`` at full width and
    depth with ``--sched auto --online-refit --slo-us --max-queue``.
    ``fixed`` is phase 4's output, printed beside this run's numbers."""
    out = {"phase": "serve_online",
           "note": "slo_us, makespan_us and predicted_us are the Ascend A3 "
                   "cost model's predicted us, not H100 times"}
    t = time.perf_counter()
    out["fragment"] = fragment_bits_case(cfg)
    out["forced_swap"] = forced_swap_case(cfg)
    out["prefill"] = online_prefill_case(cfg)
    out["checks_s"] = time.perf_counter() - t
    torch.cuda.empty_cache()

    mc = cfg.moe
    ep = serve_mod.serving_ep(mc, SLOTS, PROMPT_LEN)
    slo = serve_mod.predict_step_us(
        cfg, serve_mod.decode_population(mc, ep, SLOTS), SLO_SLOTS)
    argv = ["--arch", ARCH, "--requests", str(REQUESTS), "--slots",
            str(SLOTS), "--prompt-len", str(PROMPT_LEN), "--max-new",
            str(ONLINE_MAX_NEW), "--sched", "auto", "--online-refit",
            "--slo-us",
            repr(slo), "--max-queue", str(ONLINE_QUEUE)]
    reset_launches()
    t = time.perf_counter()
    b, stats = serve_mod.main(argv)
    wall = time.perf_counter() - t
    launches = read_launches()
    fp32 = {"tiled": gmm_mod.launches_fp32_tiled,
            "narrow": gmm_mod.launches_fp32_narrow,
            "small": gmm_mod.launches_fp32_small}
    rep = stats.pop("report")
    verdicts = stats.pop("verdicts")
    want_shed = REQUESTS - ONLINE_QUEUE
    if stats["requests"] + stats["shed"] != REQUESTS or \
            stats["shed"] != want_shed:
        raise AssertionError(f"serve_online: {stats['requests']} finished, "
                             f"{stats['shed']} shed of {REQUESTS}")
    if stats["nonfinite_steps"]:
        raise AssertionError(f"serve_online: {stats['nonfinite_steps']} "
                             f"steps had non-finite logits")
    if (launches["gmm_swiglu"] or launches["gmm"] != sum(fp32.values())
            or launches["gmm"] == 0 or any(
                v for k, v in launches.items() if k not in ("gmm",))):
        raise AssertionError(f"serve_online launches {launches} (fp32 "
                             f"{fp32}): fp32 gmm only, at least once")
    cache = rep.get("cache", {})
    out.update({
        "argv": argv, "slo_us_predicted": slo, "wall_s": wall,
        "n_slots": stats["n_slots"], "ep": rep["ep"],
        "shed_ids": b.shed, "defer_verdicts": stats["deferred"],
        "verdicts": [v for _, v in verdicts],
        "decode_step_ms_median": stats["decode_step_ms_median"],
        "prefill_ms_median": stats["prefill_ms_median"],
        "tokens_per_s": stats["tokens_per_s"], "stats": stats,
        "ssc": {"hits": cache.get("hits"), "misses": cache.get("misses"),
                "compiles": cache.get("misses"),
                "entries": cache.get("entries"),
                "pad_ratio": cache.get("pad_ratio")},
        "tuner_summary": rep["online"],
        "swaps": rep["online"]["swaps"], "refits": rep["online"]["refits"],
        "resolve_decode_sched": {"cold": rep["sched"],
                                 "live": rep.get("sched_live")},
        "admission": rep.get("admission"),
        "launches": launches,
        "gmm_fp32_launches": fp32,
        "fixed_capacity_decode_step_ms_median":
            fixed["decode_step_ms_median"],
        "fixed_capacity_prefill_ms_median": fixed["prefill_ms_median"],
        "fixed_capacity_tokens_per_s": fixed["tokens_per_s"]})
    del b
    torch.cuda.empty_cache()
    return out, launches


def _clone(tree):
    return adamw.tree_map(lambda t: t.detach().clone(), tree)


def ep_parity_case(cfg, n_layers=PARITY_LAYERS, tokens=TRAIN_SEQ,
                   dev="cuda"):
    """Phase 14 (b): one training step of ``tokens`` tokens at full width
    on ``n_layers`` layers through ``make_train_step(mesh=1 x EP, ep=
    EPConfig(mode, capacity_factor=EP_CF))``, in each mode, with the
    kernels and with the plain expert FFN, from the same params. The grads
    are those the step's ``grad_transform`` hook sees (before clipping).
    Kernels vs plain and mode vs mode: loss within LOSS_TOL relative, each
    grad leaf's norm within GNORM_TOL; whether the modes are bit-equal."""
    dev = torch.device(dev)
    pcfg = train_mod.pad_experts(dataclasses.replace(cfg, n_layers=n_layers),
                                 EP)
    params0 = adamw.cast_params(M.init_params(
        pcfg, torch.Generator(device=dev).manual_seed(0), device=dev),
        pcfg.compute_dtype)
    batch = SyntheticStream(DataConfig(vocab=pcfg.vocab, seq_len=tokens,
                                       global_batch=1)).batch(0, dev)
    runs = {}
    for mode in EP_MODES:
        for route, use_pallas in (("kernels", True), ("plain", False)):
            seen = {}

            def keep(g, seen=seen):
                seen["grads"] = _clone(g)
                return g
            step = steps_mod.make_train_step(
                pcfg, mesh=make_test_mesh(1, EP, device=dev),
                ep=EPConfig(mode=mode, capacity_factor=EP_CF,
                            use_pallas=use_pallas), grad_transform=keep)
            _, _, m = step(_clone(params0), adamw.init_opt_state(params0),
                           batch)
            runs[mode, route] = (float(m["loss"]),
                                 adamw.tree_leaves(seen["grads"]))

    def gaps(a, b):
        (la, ga), (lb, gb) = runs[a], runs[b]
        if not (math.isfinite(la) and math.isfinite(lb)):
            raise AssertionError(f"EP parity: non-finite loss {la}, {lb}")
        norm = [abs(float(x.float().norm()) - float(y.float().norm()))
                / max(float(y.float().norm()), 1e-30)
                for x, y in zip(ga, gb)]
        return {"loss": [la, lb], "loss_rel_gap": abs(la - lb) / abs(lb),
                "grad_norm_rel_gap_max": max(norm),
                "bit_equal": la == lb and all(torch.equal(x, y)
                                              for x, y in zip(ga, gb))}
    out = {"n_layers": n_layers, "tokens": tokens, "ep": EP,
           "capacity_factor": EP_CF, "loss_tol": LOSS_TOL,
           "grad_norm_tol": GNORM_TOL,
           "kernels_vs_plain": {m: gaps((m, "kernels"), (m, "plain"))
                                for m in EP_MODES},
           "modes": gaps((EP_MODES[0], "kernels"),
                         (EP_MODES[1], "kernels"))}
    for g in (*out["kernels_vs_plain"].values(), out["modes"]):
        if g["loss_rel_gap"] > LOSS_TOL or \
                g["grad_norm_rel_gap_max"] > GNORM_TOL:
            raise AssertionError(f"EP parity beyond its limits: {out}")
    return out


def run_ep_train(cfg):
    """Phase 14 (c): ``launch.train --mesh 1xEP`` at full width and depth
    in each mode. Finite losses and grad norms; per layer per step,
    gmm_swiglu 2F, gmm 4F and gmm_swiglu_bwd F launches (F the mode's
    FFN calls a forward), every one on its tensor-core body. Returns the
    rows and the launches of both runs."""
    rows, total = {}, {k: 0 for k in COUNTERS}
    for mode in EP_MODES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t = time.perf_counter()
        run = train_mod.main([
            "--arch", ARCH, "--mesh", f"1x{EP}", "--ep-mode", mode,
            "--seq", str(TRAIN_SEQ), "--global-batch", str(TRAIN_BATCH),
            "--steps", str(EP_STEPS)])
        wall = time.perf_counter() - t
        launches = read_launches()
        tc = {"gmm_swiglu": swiglu_mod.launches_tc,
              "gmm": gmm_mod.launches_tc,
              "gmm_swiglu_bwd": bwd_mod.launches_tc}
        log = run.metrics_log
        if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                   for m in log):
            raise AssertionError(f"non-finite EP training metrics: {log}")
        F = ep_bench.ffn_calls(mode, EP, 1)
        want = {k: cfg.n_layers * EP_STEPS * F * n
                for k, n in TRAIN_LAUNCHES.items()}
        if launches != want or tc != {k: want[k] for k in tc}:
            raise AssertionError(
                f"EP {mode} launches {launches} (tensor cores {tc}) != "
                f"{want} = {cfg.n_layers} layers x {EP_STEPS} steps x "
                f"{F} FFN calls x {TRAIN_LAUNCHES}")
        step_ms = statistics.median(m["step_ms"] for m in log[1:])
        tokens = TRAIN_BATCH * TRAIN_SEQ
        C = _pair_capacity(tokens // EP, cfg.moe, EP, EP_CF)
        rows[mode] = {
            "wall_s": wall, "losses": [m["loss"] for m in log],
            "grad_norms": [m["grad_norm"] for m in log],
            "step_ms": [m["step_ms"] for m in log],
            "step_ms_median_after_warmup": step_ms,
            "tokens_per_s": tokens / (step_ms / 1e3),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "collectives_per_step": log[-1]["collectives"],
            "comm_bytes_per_rank_per_step": log[-1]["comm_bytes_per_rank"],
            "ffn_calls_per_moe_forward": F, "pair_capacity": C,
            "rows_per_expert": EP * C, "launches": launches,
            "tensor_core_launches": tc}
        for k, v in launches.items():
            total[k] += v
        del run
    torch.cuda.empty_cache()
    return {"phase": "ep_train", "arch": cfg.name, "mesh": [1, EP],
            "capacity_factor": EP_CF, "seq": TRAIN_SEQ,
            "batch": TRAIN_BATCH, "steps": EP_STEPS,
            "fixed_capacity_rows_per_expert": capacity(
                TRAIN_BATCH * TRAIN_SEQ, cfg.moe), "modes": rows}, total


def run_ep_modes(argv=("--full",)):
    """Phase 14 (d): ``launch.bench_ep_modes`` (on the card, the paper's
    module at 8192 tokens a rank): each mode within bf16 tolerance of its
    plain FFN and its forward launches equal to its FFN calls (checked by
    the benchmark), then its times and bytes."""
    out = ep_bench.main(list(argv))
    for mode, r in out["modes"].items():
        times = [r["forward_ms"], r.get("forward_backward_ms", 0.0)]
        if not all(math.isfinite(t) for t in times):
            raise AssertionError(f"ep_modes {mode}: non-finite time {r}")
    return dict(out, phase="ep_modes")


def flash_decode_case(B=SLOTS, max_len=PROMPT_LEN + MAX_NEW, H=24, K=8,
                      hd=64, length=PROMPT_LEN + 3, dtype=torch.bfloat16,
                      dev="cuda"):
    """Phase 14 (e): ``make_flash_decode`` over mesh 1 x EP at the serving
    cell's decode shape (B = 8, a 160-slot cache, granite's 24/8 heads of
    64) against ``decode_attention`` on the written cache, within the bf16
    tolerance; the caches written equal."""
    from repro_torch.models.layers import decode_attention
    gen = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    q, kc, vc = rnd(B, 1, H, hd), rnd(B, max_len, K, hd), \
        rnd(B, max_len, K, hd)
    nk, nv = rnd(B, 1, K, hd), rnd(B, 1, K, hd)
    kw, vw = kc.clone(), vc.clone()
    kw[:, length], vw[:, length] = nk[:, 0], nv[:, 0]
    want = decode_attention(q, kw, vw, torch.tensor(length + 1, device=dev))
    fd = make_flash_decode(make_test_mesh(1, EP, device=dev))
    got, kc2, vc2 = fd(q, kc, vc, nk, nv, torch.tensor(length, device=dev))
    err = float((got.float() - want.float()).abs().max())
    tol = TOL[dtype]
    if not (err <= tol * max(1.0, float(want.float().abs().max()))
            and torch.equal(kc2, kw) and torch.equal(vc2, vw)):
        raise AssertionError(f"flash decoding differs from decode_attention"
                             f": {err}")
    return {"B": B, "max_len": max_len, "heads": H, "kv_heads": K, "hd": hd,
            "cache_len": length, "dtype": str(dtype)[6:],
            "max_abs_err": err, "tol": tol, "caches_equal": True}


def dist_case(cfg, backend="nccl", tokens=512, dev="cuda", init_dir=None):
    """Phase 14 (e): a one-rank ``torch.distributed`` group (NCCL on the
    card) runs one full-width MoE layer through ``make_moe_ep`` at ep = 1
    on the process mesh ``dist_mesh((1, 1))`` in both modes, forward and
    backward; y and every grad must equal the ``VirtualComm`` run's bit for
    bit."""
    import torch.distributed as dist
    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    params = init_moe(gen, cfg.d_model, cfg.moe, cfg.compute_dtype)
    x = torch.randn((1, tokens, cfg.d_model), generator=gen,
                    device=dev).to(cfg.compute_dtype)
    dy = torch.randn(x.shape, generator=gen, device=dev).to(x.dtype)

    def run(mesh, mode):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        xx = x.clone().requires_grad_(True)
        y = make_moe_ep(mesh, EPConfig(mode=mode))(p, xx, cfg.moe)
        y.backward(dy)
        return [y.detach(), xx.grad] + [p[k].grad for k in sorted(p)]
    with tempfile.TemporaryDirectory(dir=init_dir) as d:
        dist.init_process_group(backend, init_method=f"file://{d}/init",
                                world_size=1, rank=0)
        try:
            got = {m: run(dist_mesh((1, 1)), m) for m in EP_MODES}
        finally:
            dist.destroy_process_group()
    out = {"backend": backend, "tokens": tokens, "modes": {}}
    for mode in EP_MODES:
        want = run(make_test_mesh(1, 1, device=dev), mode)
        if not all(torch.equal(a, b) for a, b in zip(got[mode], want)):
            raise AssertionError(f"{backend} {mode}: DistComm differs from "
                                 f"VirtualComm")
        out["modes"][mode] = {"bit_equal": True}
    return out


def run_ep(cfg):
    """Phase 14 (b), (c), (d) and (e) on the card; (a) runs in phase 3.
    Returns the phase's line and the launches of paths ep_train and
    ep_modes."""
    out = {"phase": "ep", "ep_parity": ep_parity_case(cfg)}
    torch.cuda.empty_cache()
    train_out, train_launches = run_ep_train(cfg)
    emit(train_out)
    reset_launches()
    modes_out = run_ep_modes()
    modes_launches = read_launches()
    emit(modes_out)
    torch.cuda.empty_cache()
    out["ep_flash_decode"] = flash_decode_case()
    out["ep_nccl"] = dist_case(cfg, init_dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    return out, {"ep_train": train_launches, "ep_modes": modes_launches}


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in adamw.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def manifest_bytes(step_dir) -> int:
    """The bytes of a checkpoint's arrays, from its manifest."""
    with open(os.path.join(step_dir, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    size = {"bfloat16": 2, "float32": 4, "int32": 4}
    return sum(math.prod(v["shape"]) * size[v["dtype"]]
               for v in leaves.values())


def ft_train_case(cfg, root, dev="cuda", seq=TRAIN_SEQ):
    """Phase 15 (a): an uninterrupted run, a crashed one and its resume at
    full width on PARITY_LAYERS layers, checkpoints under ``root``. On the
    card the kernels' launches must be TRAIN_LAUNCHES a layer a step, all
    on tensor cores, and the in-place resume must add at most one leaf's
    bytes of device memory to the fresh state it fills."""
    dev = torch.device(dev)
    cuda = dev.type == "cuda"
    pcfg = dataclasses.replace(cfg, n_layers=PARITY_LAYERS)
    oc = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=FT_STEPS)
    step_fn = steps_mod.make_train_step(pcfg, oc)
    stream = SyntheticStream(DataConfig(vocab=pcfg.vocab, seq_len=seq,
                                        global_batch=TRAIN_BATCH))

    def fresh():
        params = adamw.cast_params(M.init_params(
            pcfg, torch.Generator(device=dev).manual_seed(0), device=dev),
            pcfg.compute_dtype)
        return params, adamw.init_opt_state(params)

    params, opt_state = fresh()
    state = tree_bytes((params, opt_state))
    leaf = max(t.numel() * t.element_size()
               for t in adamw.tree_leaves((params, opt_state))
               if isinstance(t, torch.Tensor))
    free = shutil.disk_usage(root).free
    if free < 2 * state:
        raise RuntimeError(f"{root} has {free} bytes free; two checkpoints "
                           f"of {state} bytes do not fit")

    def loop(name, params, opt_state, inject=None):
        return ft_runner.train_loop(
            step_fn=step_fn, params=params, opt_state=opt_state,
            stream=stream, mesh=None, device=dev, n_steps=FT_STEPS,
            ft=ft_runner.FTConfig(ckpt_dir=os.path.join(root, name),
                                  ckpt_every=FT_EVERY, keep=FT_KEEP),
            inject_fault=inject, log_every=1, layout=JaxTrainLayout)

    def bomb(step):
        if step == FT_CRASH:
            raise RuntimeError(f"injected kill at step {FT_CRASH}")

    mem = {}

    def restore_peak(step):
        # Called before each resumed step: the first call follows the
        # restore and precedes any step's activations.
        if cuda and "peak" not in mem:
            torch.cuda.synchronize(dev)
            mem["peak"] = torch.cuda.max_memory_allocated(dev)

    torch.use_deterministic_algorithms(True)
    try:
        reset_launches()
        base = loop("base", params, opt_state)
        ckpt_bytes = manifest_bytes(
            ckpt_mod.latest_step_dir(os.path.join(root, "base")))
        shutil.rmtree(os.path.join(root, "base"))
        try:
            loop("crash", *fresh(), inject=bomb)
            raise AssertionError("the injected fault did not fire")
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
        params, opt_state = fresh()
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            mem["before"] = torch.cuda.memory_allocated(dev)
        run = loop("crash", params, opt_state, inject=restore_peak)
        del params, opt_state
        launches = read_launches()
        tc = {"gmm_swiglu": swiglu_mod.launches_tc,
              "gmm": gmm_mod.launches_tc,
              "gmm_swiglu_bwd": bwd_mod.launches_tc}
    finally:
        torch.use_deterministic_algorithms(False)

    def log(r):
        return [(m["step"], m["loss"], m["grad_norm"]) for m in r.metrics_log]
    a = adamw.tree_leaves((base.params, base.opt_state))
    b = adamw.tree_leaves((run.params, run.opt_state))
    unequal = [i for i, (x, y) in enumerate(zip(a, b))
               if not (x == y if isinstance(x, int) else torch.equal(x, y))]
    steps_run = FT_STEPS + FT_CRASH + (FT_STEPS - FT_EVERY)
    want = {k: PARITY_LAYERS * steps_run * n
            for k, n in TRAIN_LAUNCHES.items()}
    added = mem["peak"] - mem["before"] if cuda else None
    out = {"n_layers": PARITY_LAYERS, "tokens": TRAIN_BATCH * seq,
           "steps": FT_STEPS, "ckpt_every": FT_EVERY, "keep": FT_KEEP,
           "crash_before_step": FT_CRASH, "resumed_from": run.resumed_from,
           "log": log(run), "log_uninterrupted": log(base),
           "log_bit_equal": log(run) == log(base),
           "state_leaves": len(a), "state_leaves_unequal": unequal,
           "state_bytes": state, "largest_leaf_bytes": leaf,
           "checkpoint_bytes": ckpt_bytes, "disk_free_bytes": free,
           "restore_device_bytes_before": mem.get("before"),
           "restore_device_peak_bytes": mem.get("peak"),
           "restore_device_bytes_added": added,
           "deterministic_algorithms": True,
           "ckpt": [dict(e, run=name, gb_per_s=e["bytes"] / e["s"] / 1e9)
                    for name, r in (("uninterrupted", base),
                                    ("resumed", run))
                    for e in r.ckpt_log],
           "step_s": [m["step_time_s"] for m in run.metrics_log],
           "launches": launches, "launches_tc": tc,
           "expected_launches": want}
    if run.resumed_from != FT_EVERY or not out["log_bit_equal"] \
            or unequal or len(a) != len(b):
        raise AssertionError(f"the resumed run differs from the "
                             f"uninterrupted one: {out}")
    if cuda and (launches != want or tc != {k: want[k] for k in tc}):
        raise AssertionError(f"ft launch counts {launches} (tensor cores "
                             f"{tc}) != {want}")
    if cuda and added > leaf:
        raise AssertionError(f"the resume added {added} bytes of device "
                             f"memory to the fresh state; one leaf is "
                             f"{leaf}")
    if not all(math.isfinite(m[1]) for m in log(run)):
        raise AssertionError(f"non-finite FT losses: {log(run)}")
    return out, launches


def ft_harness_case(root, dev="cuda"):
    """Phase 15 (b): the chaos harness's six cells on the card, where its
    fragment launches ``gmm`` and no other kernel."""
    reset_launches()
    torch.use_deterministic_algorithms(True)
    try:
        cells = [{"scenario": kind, "profile": profile,
                  "checks": ft_harness.run_scenario(
                      kind, profile, os.path.join(root, f"{kind}_{profile}"),
                      device=dev)}
                 for kind in ft_harness.KINDS
                 for profile in ft_harness.PROFILES]
    finally:
        torch.use_deterministic_algorithms(False)
    launches = read_launches()
    failed = [c for c in cells if not all(c["checks"].values())]
    if failed:
        raise AssertionError(f"harness cells failed on the card: {failed}")
    if torch.device(dev).type == "cuda" and (
            launches["gmm"] == 0
            or any(v for k, v in launches.items() if k != "gmm")):
        raise AssertionError(f"harness launches {launches}: gmm only, at "
                             f"least once")
    return cells, launches


def run_ft(cfg):
    """Phase 15. Returns the phase's line and the launches of paths ft and
    ft_harness."""
    t = time.perf_counter()
    root = tempfile.mkdtemp()
    try:
        torch.cuda.empty_cache()
        train_out, train_launches = ft_train_case(cfg, root)
        torch.cuda.empty_cache()
        cells, harness_launches = ft_harness_case(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"phase": "ft", **train_out, "harness": cells,
           "harness_launches": harness_launches,
           "harness_gmm_fp32_launches": {
               "narrow": gmm_mod.launches_fp32_narrow,
               "small": gmm_mod.launches_fp32_small},
           "seconds": time.perf_counter() - t}
    return out, {"ft": train_launches, "ft_harness": harness_launches}


def _free(dev="cuda") -> None:
    """Release the cached blocks of the arch just run, so that the next
    arch's peak is its own."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _peak(dev="cuda"):
    return (torch.cuda.max_memory_allocated()
            if torch.device(dev).type == "cuda" else None)


def family_consistency_case(arch, n_layers, prompt, steps, dev="cuda",
                            cfg=None):
    """Phase 16 (a): ``arch`` (or ``cfg``) at full width, cut to
    ``n_layers``, fp32: the prefill's last logits and ``steps``
    teacher-forced decode steps against the forward on the same prompt +
    steps tokens."""
    cfg = dataclasses.replace(cfg or get_config(arch), n_layers=n_layers,
                              dtype="float32")
    params = M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    S = prompt + steps
    toks = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (1, S)), device=dev)
    with torch.inference_mode():
        full = M.forward(cfg, params, {"tokens": toks})[0]
        last, cache = M.prefill(cfg, params, {"tokens": toks[:, :prompt]},
                                max_len=S)
        errs = [float((last[0] - full[prompt - 1]).abs().max())]
        for t in range(prompt, S):
            lg, cache = M.decode_step(cfg, params, toks[:, t:t + 1], cache)
            errs.append(float((lg[0, 0] - full[t]).abs().max()))
    scale = float(full[prompt - 1:].abs().max())
    out = {"arch": arch, "n_layers": n_layers, "dtype": "float32",
           "prompt": prompt, "decode_steps": steps,
           "prefill_max_abs_err": errs[0],
           "decode_max_abs_err": max(errs[1:]), "logit_max_abs": scale,
           "tol": FAMILY_TOL, "limit": FAMILY_TOL * scale}
    if cfg.family == "hybrid":
        ring = cache["super"][-1][0]
        out["ring_slots"] = ring["k"].shape[1]
        out["ring_tokens"] = int(ring["len"])
        if not out["ring_tokens"] > out["ring_slots"] == cfg.sliding_window:
            raise AssertionError(f"the window cache did not wrap: {out}")
    finite = bool(torch.isfinite(full).all())
    del params, cache, full
    if not finite or max(errs) > FAMILY_TOL * scale:
        raise AssertionError(f"{arch}: prefill and decode disagree with "
                             f"the forward: {out}")
    return out


def family_serve_case(arch, dev="cuda", cfg=None, requests=REQUESTS,
                      prompt_len=PROMPT_LEN):
    """Phase 16 (b): ``arch`` (or ``cfg``) at full width and depth, bf16,
    serving phase 4's traffic through ``launch.serve.serve``. No kernel of
    the port is on this path (the matmuls are cuBLAS, as the reference's
    are plain XLA)."""
    cfg = cfg or get_config(arch)
    _free(dev)
    params = M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    prompts = {i: rng.integers(0, cfg.vocab, prompt_len)
               for i in range(requests)}
    reset_launches()
    with torch.inference_mode():
        b, stats = serve_mod.serve(cfg, params, prompts, n_slots=SLOTS,
                                   max_new=MAX_NEW, device=dev)
    launches = read_launches()
    out = {"arch": arch, "n_layers": cfg.n_layers,
           "params": cfg.param_count(), "launches": launches,
           "max_memory_allocated_bytes": _peak(dev),
           **{k: stats[k] for k in (
               "requests", "tokens", "wall_s", "tokens_per_s", "prefills",
               "decode_steps", "prefill_ms_median", "decode_step_ms_median",
               "nonfinite_steps")}}
    ok = (stats["requests"] == requests
          and all(len(b.generated[r]) == MAX_NEW for r in prompts)
          and not stats["nonfinite_steps"] and not any(launches.values()))
    del b, params
    if not ok:
        raise AssertionError(f"{arch} serving failed its gates: {out}")
    return out


def family_train_case(arch, dev="cuda", argv=()):
    """Phase 16 (c): ``launch.train.main --arch`` at full width and depth,
    FAMILY_TRAIN_STEPS steps of 1 x TRAIN_SEQ tokens (the first warm-up);
    ``argv`` is appended (the CPU test's ``--smoke``, ``--seq``). The arch
    has no MoE layer, so no kernel of the port may launch."""
    _free(dev)
    reset_launches()
    run = train_mod.main(["--arch", arch, "--seq", str(TRAIN_SEQ),
                          "--global-batch", str(TRAIN_BATCH),
                          "--steps", str(FAMILY_TRAIN_STEPS),
                          "--device", str(dev), *argv])
    launches = read_launches()
    log = run.metrics_log
    step_ms = [m["step_ms"] for m in log]
    seq = TRAIN_SEQ if "--seq" not in argv else int(
        argv[list(argv).index("--seq") + 1])
    out = {"arch": arch, "params": get_config(arch).param_count(),
           "seq": seq, "losses": [m["loss"] for m in log],
           "grad_norms": [m["grad_norm"] for m in log], "step_ms": step_ms,
           "step_ms_median_after_warmup": statistics.median(step_ms[1:]),
           "tokens_per_s": TRAIN_BATCH * seq
           / (statistics.median(step_ms[1:]) / 1e3),
           "launches": launches, "max_memory_allocated_bytes": _peak(dev)}
    del run
    if not all(math.isfinite(x) for x in out["losses"] + out["grad_norms"]):
        raise AssertionError(f"{arch}: non-finite training metrics: {out}")
    if any(launches.values()):
        raise AssertionError(f"{arch} has no MoE layer, yet its training "
                             f"launched a kernel: {out}")
    return out


def dbrx_case(dev="cuda", cfg=None, prompt_len=PROMPT_LEN):
    """Phase 16 (d): dbrx-132b (or ``cfg``) at full width cut to
    DBRX_LAYERS layers, bf16: one ``prompt_len``-token prefill through the
    kernels against the plain expert FFN, then DBRX_REQUESTS requests
    served. Returns the line and the serving launches."""
    cfg = dataclasses.replace(cfg or get_config(DBRX), n_layers=DBRX_LAYERS)
    _free(dev)
    params = M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    prompts = {i: rng.integers(0, cfg.vocab, prompt_len)
               for i in range(DBRX_REQUESTS)}
    toks = torch.as_tensor(prompts[0][None, :], device=dev)
    max_len = prompt_len + MAX_NEW + 1
    with torch.inference_mode():
        lk, _ = M.prefill(cfg, params, {"tokens": toks}, max_len)
        lp, _ = M.prefill(cfg, params, {"tokens": toks}, max_len,
                          moe_impl=plain_moe_impl(cfg))
    lk, lp = lk.float(), lp.float()
    err, scale = float((lk - lp).abs().max()), float(lp.abs().max())
    finite = bool(torch.isfinite(lk).all() and torch.isfinite(lp).all())
    _free(dev)
    reset_launches()
    with torch.inference_mode():
        b, stats = serve_mod.serve(cfg, params, prompts, n_slots=SLOTS,
                                   max_new=MAX_NEW, device=dev)
    launches = read_launches()
    want = cfg.n_layers * (stats["prefills"] + stats["decode_steps"])
    out = {"arch": DBRX, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "params": cfg.param_count(),
           "full_depth_params": get_config(DBRX).param_count(),
           "logit_max_abs_err": err, "logit_max_abs": scale,
           "logit_tol": LOGIT_TOL, "top1_agree": bool(
               lk.argmax() == lp.argmax()),
           "launches": launches, "expected_launches": want,
           "max_memory_allocated_bytes": _peak(dev),
           **{k: stats[k] for k in (
               "requests", "tokens", "prefills", "decode_steps",
               "prefill_ms_median", "decode_step_ms_median", "tokens_per_s",
               "nonfinite_steps")}}
    ok = (finite and err <= LOGIT_TOL * scale
          and stats["requests"] == DBRX_REQUESTS
          and all(len(b.generated[r]) == MAX_NEW for r in prompts)
          and not stats["nonfinite_steps"]
          and launches == dict({k: 0 for k in COUNTERS}, gmm_swiglu=want,
                               gmm=want))
    del b, params
    if not ok:
        raise AssertionError(f"dbrx-132b failed its gates: {out}")
    return out, launches


def dbrx_train_case(dev="cuda", cfg=None, seq=TRAIN_SEQ):
    """Phase 16 (e): dbrx-132b's (or ``cfg``'s) training step at full width
    cut to DBRX_LAYERS layers, bf16, on one 1 x ``seq`` batch: the loss
    and every grad (``steps.value_and_grad``, the step without its AdamW
    update) through the kernels, with each launch count equal to
    TRAIN_LAUNCHES x the layers and every backward on the tensor cores,
    and through the plain expert FFN, held to each other as phase 5 holds
    granite's (LOSS_TOL, GNORM_TOL). The update launches no kernel, and
    its fp32 moments and masters (12 bytes a parameter, on top of the
    bf16 weights and grads) would not fit one card even at 2 layers.
    Returns the line and the launches."""
    cfg = dataclasses.replace(cfg or get_config(DBRX), n_layers=DBRX_LAYERS)
    _free(dev)
    params = adamw.cast_params(M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev),
        cfg.compute_dtype)
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                        global_batch=TRAIN_BATCH))
    batch = stream.batch(0, dev)

    def loss_and_norms(moe_impl=None):
        loss, grads = steps_mod.value_and_grad(cfg, params, batch,
                                               moe_impl=moe_impl)
        norms = [float(g.float().norm()) for g in adamw.tree_leaves(grads)]
        return float(loss), norms

    reset_launches()
    t = time.perf_counter()
    lk, nk = loss_and_norms()
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    launches, bwd_tc = read_launches(), bwd_mod.launches_tc
    peak = _peak(dev)
    lp, np_ = loss_and_norms(plain_train_impl(cfg))
    want = {k: cfg.n_layers * n for k, n in TRAIN_LAUNCHES.items()}
    gaps = [abs(a - b) / max(b, 1e-30) for a, b in zip(nk, np_)]
    out = {"arch": DBRX, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "tokens": TRAIN_BATCH * seq,
           "capacity": capacity(TRAIN_BATCH * seq, cfg.moe),
           "loss_kernels": lk, "loss_plain": lp,
           "loss_rel_gap": abs(lk - lp) / abs(lp), "loss_tol": LOSS_TOL,
           "grad_leaves": len(gaps), "grad_norm_rel_gap_max": max(gaps),
           "grad_norm_tol": GNORM_TOL, "value_and_grad_s": step_s,
           "launches": launches, "expected_launches": want,
           "gmm_swiglu_bwd_tensor_core_launches": bwd_tc,
           "max_memory_allocated_bytes": peak}
    del params, batch
    ok = (math.isfinite(lk) and math.isfinite(lp)
          and all(math.isfinite(n) for n in nk + np_)
          and out["loss_rel_gap"] <= LOSS_TOL and max(gaps) <= GNORM_TOL
          and launches == want and bwd_tc == want["gmm_swiglu_bwd"])
    if not ok:
        raise AssertionError(f"dbrx-132b's training step failed its "
                             f"gates: {out}")
    return out, launches


def run_families():
    """Phase 16. Returns the phase's line and the launches of paths
    families (dbrx's serving) and families_train (dbrx's training step);
    the other families launch no kernel."""
    t = time.perf_counter()
    consistency = []
    for arch, (n_layers, prompt, steps) in FAMILY_CONSISTENCY.items():
        _free()
        consistency.append(family_consistency_case(arch, n_layers, prompt,
                                                   steps))
    serving = [family_serve_case(arch) for arch in FAMILY_FULL]
    training = [family_train_case(arch) for arch in FAMILY_FULL]
    dbrx_out, launches = dbrx_case()
    dbrx_train, train_launches = dbrx_train_case()
    _free()
    return ({"phase": "families", "consistency": consistency,
             "serving": serving, "training": training, "dbrx": dbrx_out,
             "dbrx_train": dbrx_train, "seconds": time.perf_counter() - t},
            {"families": launches, "families_train": train_launches})


def vlm_consistency_case(dev="cuda", cfg=None, prompt=PROMPT_LEN,
                         steps=VLM_STEPS):
    """Phase 17 (a): internvl2-26b (or ``cfg``) at full width cut to
    AV_LAYERS layers, fp32: the prefill over its patches + ``prompt``
    tokens and ``steps`` teacher-forced decode steps against the forward
    on the same patches and tokens; the logits without the patches must
    differ."""
    cfg = dataclasses.replace(cfg or get_config(VLM), n_layers=AV_LAYERS,
                              dtype="float32")
    params = M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    S = prompt + steps
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, S)), device=dev)
    patches = torch.as_tensor(rng.standard_normal(
        (1, cfg.n_patches, cfg.d_model), dtype=np.float32), device=dev)
    with torch.inference_mode():
        full = M.forward(cfg, params, {"tokens": toks, "patches": patches})[0]
        bare = M.forward(cfg, params, {"tokens": toks})[0]
        last, cache = M.prefill(
            cfg, params, {"tokens": toks[:, :prompt], "patches": patches},
            max_len=cfg.n_patches + S)
        errs = [float((last[0] - full[prompt - 1]).abs().max())]
        for t in range(prompt, S):
            lg, cache = M.decode_step(cfg, params, toks[:, t:t + 1], cache)
            errs.append(float((lg[0, 0] - full[t]).abs().max()))
    scale = float(full[prompt - 1:].abs().max())
    moved = float((full - bare).abs().max())
    out = {"arch": VLM, "n_layers": cfg.n_layers, "dtype": "float32",
           "patches": cfg.n_patches, "prompt": prompt, "decode_steps": steps,
           "prefill_max_abs_err": errs[0],
           "decode_max_abs_err": max(errs[1:]), "logit_max_abs": scale,
           "tol": FAMILY_TOL, "limit": FAMILY_TOL * scale,
           "cache_len": int(cache[0]["len"]),
           "patches_move_logits_by": moved}
    finite = bool(torch.isfinite(full).all())
    del params, cache, full, bare
    if (not finite or max(errs) > FAMILY_TOL * scale
            or moved <= FAMILY_TOL * scale
            or out["cache_len"] != cfg.n_patches + S):
        raise AssertionError(f"{VLM}: prefill and decode with patches "
                             f"disagree with the forward: {out}")
    return out


def audio_consistency_case(dev="cuda", cfg=None, frames=AUDIO_FRAMES):
    """Phase 17 (a): hubert-xlarge (or ``cfg``) at full width cut to
    AV_LAYERS layers, fp32: the encoder forward on ``dev`` against the same
    forward on the CPU (the same params, drawn on the CPU); then, on
    ``dev``, a change to the last frame moves the first frame's logits (no
    causal mask)."""
    cfg = dataclasses.replace(cfg or get_config(AUDIO), n_layers=AV_LAYERS,
                              dtype="float32")
    host = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = adamw.tree_map(lambda t: t.to(dev), host)
    feats = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (1, frames, cfg.feat_in), dtype=np.float32))
    moved_feats = feats.clone()
    moved_feats[:, -1] += 1.0
    with torch.inference_mode():
        want = M.forward(cfg, host, {"features": feats})[0]
        got = M.forward(cfg, params, {"features": feats.to(dev)})[0].cpu()
        moved = M.forward(cfg, params,
                          {"features": moved_feats.to(dev)})[0].cpu()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    first = float((moved[0] - got[0]).abs().max())
    out = {"arch": AUDIO, "n_layers": cfg.n_layers, "dtype": "float32",
           "frames": frames, "max_abs_err_vs_cpu": err,
           "logit_max_abs": scale, "tol": AUDIO_TOL,
           "limit": AUDIO_TOL * scale,
           "first_frame_moved_by": first}
    del host, params
    if (not bool(torch.isfinite(got).all()) or err > AUDIO_TOL * scale
            or first <= AUDIO_TOL * scale):
        raise AssertionError(f"{AUDIO}: the encoder on the card failed its "
                             f"gates: {out}")
    return out


def _timed(fn, dev, repeats=AV_REPEATS):
    """``fn()`` once to warm up, then ``repeats`` times: the last result
    and the host ms of each timed call, each ending in a synchronize."""
    out = fn()
    ms = []
    for _ in range(repeats):
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
    return out, ms


def av_batch(cfg, batch, seq, dev, seed=0, labels=False):
    """``batch`` x ``seq`` inputs of the arch, as the dry run counts them
    (``configs.shapes.input_specs``): features (audio), or tokens and the
    patches (vlm); with ``labels``, the training batch's labels too."""
    rng = np.random.default_rng(seed)
    dt = cfg.compute_dtype

    def normal(*shape):
        return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32),
                               device=dev).to(dt)

    out = {}
    if labels:
        out["labels"] = torch.as_tensor(
            rng.integers(0, cfg.vocab, (batch, seq)), device=dev)
    if cfg.family == "audio":
        out["features"] = normal(batch, seq, cfg.feat_in)
    else:
        out["tokens"] = torch.as_tensor(
            rng.integers(0, cfg.vocab, (batch, seq)), device=dev)
        out["patches"] = normal(batch, cfg.n_patches, cfg.d_model)
    return out


def prefill_step_case(arch, dev="cuda", cfg=None, batch=1, seq=None):
    """Phase 17 (b): ``arch``'s (or ``cfg``'s) ``prefill_step`` at full
    depth, bf16, on ``batch`` sequences: hubert's encoder forward over
    ``seq`` frames (default prefill_32k's 32,768, its batch of 32 cut to
    1), or internvl2's prefill over its 256 patches + ``seq`` tokens."""
    cfg = cfg or get_config(arch)
    seq = seq or SHAPES["prefill_32k"].seq_len
    _free(dev)
    params = M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    inputs = av_batch(cfg, batch, seq, dev)
    audio = cfg.family == "audio"
    max_len = seq + (0 if audio else cfg.n_patches)
    fns = steps_mod.make_steps(cfg, make_test_mesh(1, 1, device=dev))
    reset_launches()
    with torch.inference_mode():
        (logits, cache), ms = _timed(
            lambda: fns.prefill_step(params, inputs, max_len), dev)
    launches = read_launches()
    med = statistics.median(ms)
    out = {"arch": arch, "n_layers": cfg.n_layers,
           "params": cfg.param_count(), "batch": batch, "seq": seq,
           "patches": 0 if audio else cfg.n_patches, "ms": ms,
           "ms_median": med, "tokens_per_s": batch * seq / (med / 1e3),
           "launches": launches, "max_memory_allocated_bytes": _peak(dev)}
    want = (batch, seq, cfg.padded_vocab) if audio else (batch,
                                                         cfg.padded_vocab)
    ok = (bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == want and not any(launches.values())
          and (cache is None if audio else int(cache[0]["len"]) == max_len))
    del params, inputs, logits, cache
    if not ok:
        raise AssertionError(f"{arch}'s prefill step failed its gates: "
                             f"{out}")
    return out


def av_train_case(arch, dev="cuda", cfg=None, seq=TRAIN_SEQ,
                  steps=FAMILY_TRAIN_STEPS):
    """Phase 17 (c): ``steps`` training steps of ``arch`` (or ``cfg``),
    bf16 with fp32 AdamW, through ``launch.steps.make_train_step`` on
    1 x ``seq`` batches (the first step is warm-up). Finite losses and grad
    norms; no kernel launch (no MoE layer)."""
    cfg = cfg or get_config(arch)
    _free(dev)
    params = adamw.cast_params(M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev),
        cfg.compute_dtype)
    state = adamw.init_opt_state(params)
    step = steps_mod.make_train_step(cfg, adamw.OptConfig(
        lr=1e-3, warmup_steps=2, total_steps=steps))
    reset_launches()
    log = []
    for i in range(steps):
        batch = av_batch(cfg, 1, seq, dev, seed=i, labels=True)
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, m = step(params, state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        log.append((1e3 * (time.perf_counter() - t), loss, gnorm))
    launches = read_launches()
    step_ms = [x[0] for x in log]
    med = statistics.median(step_ms[1:])
    out = {"arch": arch, "n_layers": cfg.n_layers,
           "full_depth_layers": get_config(arch).n_layers,
           "params": cfg.param_count(), "seq": seq,
           "losses": [x[1] for x in log], "grad_norms": [x[2] for x in log],
           "step_ms": step_ms, "step_ms_median_after_warmup": med,
           "tokens_per_s": seq / (med / 1e3), "launches": launches,
           "max_memory_allocated_bytes": _peak(dev)}
    del params, state, step
    if not all(math.isfinite(x) for x in out["losses"] + out["grad_norms"]):
        raise AssertionError(f"{arch}: non-finite training metrics: {out}")
    if any(launches.values()):
        raise AssertionError(f"{arch} has no MoE layer, yet its training "
                             f"launched a kernel: {out}")
    return out


def run_cells(vlm_cfg=None, audio_cfg=None, vlm_train_cfg=None,
              prompt_len=PROMPT_LEN, patch_batch=PATCH_BATCH,
              frames=None, seq=TRAIN_SEQ):
    """Phase 17 (d)'s counts of the runs of (b) and (c), each at the run's
    own batch and depth: {label: (cfg, ShapeSpec)}. The serving decode
    step counts the 8 slots' cache (scalar lengths; the batcher's are per
    slot); its prefills, one request of tokens alone, are not counted."""
    vlm_cfg = vlm_cfg or get_config(VLM)
    audio_cfg = audio_cfg or get_config(AUDIO)
    vlm_train_cfg = vlm_train_cfg or dataclasses.replace(
        vlm_cfg, n_layers=VLM_TRAIN_LAYERS)
    frames = frames or SHAPES["prefill_32k"].seq_len
    return {
        "vlm_decode_step": (vlm_cfg, ShapeSpec(
            "serve_decode", prompt_len + MAX_NEW + 1, SLOTS, "decode")),
        "vlm_patch_prefill": (vlm_cfg, ShapeSpec(
            "patch_prefill", prompt_len, patch_batch, "prefill")),
        "audio_prefill": (audio_cfg, ShapeSpec("prefill_32k", frames, 1,
                                               "prefill")),
        "audio_train": (audio_cfg, ShapeSpec("train_4k", seq, 1, "train")),
        "vlm_train": (vlm_train_cfg, ShapeSpec("train_4k", seq, 1,
                                               "train"))}


def dryrun_grid(archs=None, shapes=None):
    """Every (cfg, shape) cell of the grid that ``skip_reason`` keeps."""
    archs = archs or dryrun_mod.DRYRUN_ARCHS
    return [(get_config(a), s) for a in archs for s in (shapes or SHAPES)
            if skip_reason(get_config(a), s) is None]


def dryrun_check(grid, runs, results, measured, seconds,
                 workers=DRYRUN_WORKERS):
    """Phase 17 (d)'s line from ``dryrun.count_all``'s ``results`` of
    ``grid`` + ``runs`` (``run_cells``) and each run's ``measured`` (ms,
    peak device bytes). Gates: 0 failures; every train and prefill cell's
    FLOPs at least ``model_flops`` less the products no step makes
    (``lookup_flops``); each run's share of the roofline, max(t_compute,
    t_memory) / its measured time, at most SHARE_MAX. The counted peak
    (arguments + live bytes) is printed beside the card's, not gated."""
    cells, failures, low = [], [], []
    for (cfg, s), (row, fail) in zip(grid, results):
        if fail is not None:
            failures.append(fail)
            continue
        floor = row["model_flops"] - dryrun_mod.lookup_flops(cfg, s)
        cells.append(dict({k: row[k] for k in (
            "arch", "shape", "t_compute_s", "t_memory_s", "bottleneck",
            "model_flops", "flops_per_dev", "bytes_per_dev",
            "roofline_frac", "hbm_args_gb", "hbm_temp_gb", "count_s")},
            flops_floor=floor))
        if SHAPES[s].kind != "decode" and row["flops_per_dev"] < floor:
            low.append((row["arch"], s))
    shares = []
    for (label, (cfg, sp)), (row, fail) in zip(runs.items(),
                                               results[len(grid):]):
        if fail is not None:
            failures.append(fail)
            continue
        ms, peak = measured[label]
        shares.append({
            "run": label, "arch": cfg.name, "n_layers": cfg.n_layers,
            "batch": sp.global_batch, "seq": sp.seq_len, "kind": sp.kind,
            "t_compute_ms": 1e3 * row["t_compute_s"],
            "t_memory_ms": 1e3 * row["t_memory_s"],
            "bottleneck": row["bottleneck"], "measured_ms": ms,
            "roofline_share": max(row["t_compute_s"], row["t_memory_s"])
            / (ms / 1e3),
            "counted_peak_bytes": (row["hbm_args_gb"] + row["hbm_temp_gb"])
            * 2**30, "max_memory_allocated_bytes": peak,
            "kernels": row["kernels"], "count_s": row["count_s"]})
    out = {"cells": cells, "failures": failures, "flops_below_floor": low,
           "runs": shares, "workers": workers, "seconds": seconds,
           "cell_count_s_sum": sum(c["count_s"] for c in cells)}
    if failures or low or any(s["roofline_share"] > SHARE_MAX
                              for s in shares):
        raise AssertionError(f"the dry run failed its gates: {json.dumps(
            {k: out[k] for k in ('failures', 'flops_below_floor', 'runs')})}")
    return out


def run_measurements(serving, patch_prefill, audio_prefill,
                     training) -> dict:
    """Each run of ``run_cells``: (its measured ms, its peak device bytes)
    from the lines of (b) and (c)."""
    out = {"vlm_decode_step": (serving["decode_step_ms_median"],
                               serving["max_memory_allocated_bytes"])}
    for label, run in (("vlm_patch_prefill", patch_prefill),
                       ("audio_prefill", audio_prefill)):
        out[label] = (run["ms_median"], run["max_memory_allocated_bytes"])
    for label, tr in zip(("audio_train", "vlm_train"), training):
        out[label] = (tr["step_ms_median_after_warmup"],
                      tr["max_memory_allocated_bytes"])
    return out


def _sum_launches(*outs) -> dict:
    return {k: sum(o["launches"][k] for o in outs) for k in COUNTERS}


def run_audio_vlm(counts: BackgroundCounts):
    """Phase 17. Returns the phase's line and the launches of paths
    audio_vlm (internvl2's serving and patch prefill, hubert's prefill) and
    audio_vlm_train, gated at 0 in each case: these families run no GMM
    kernel. (d) gates ``counts``' group ``audio_vlm`` (``dryrun_grid``,
    then ``run_cells``' runs), counted while the card worked on the phases
    before."""
    t = time.perf_counter()
    _free()
    consistency = [vlm_consistency_case()]
    _free()
    consistency.append(audio_consistency_case())
    serving = family_serve_case(VLM)
    patch_prefill = prefill_step_case(VLM, batch=PATCH_BATCH,
                                      seq=PROMPT_LEN)
    runs = run_cells()
    training = [av_train_case(AUDIO),
                av_train_case(VLM, cfg=runs["vlm_train"][0])]
    _free()
    audio_prefill = prefill_step_case(AUDIO)
    _free()
    results, dry_s, waited = counts.result("audio_vlm")
    dry = dryrun_check(dryrun_grid(), runs, results, run_measurements(
        serving, patch_prefill, audio_prefill, training), dry_s)
    dry["waited_s"] = waited
    return ({"phase": "audio_vlm", "consistency": consistency,
             "serving": serving, "prefill_steps": [patch_prefill,
                                                   audio_prefill],
             "training": training, "dryrun": dry,
             "seconds": time.perf_counter() - t},
            {"audio_vlm": _sum_launches(serving, patch_prefill,
                                        audio_prefill),
             "audio_vlm_train": _sum_launches(*training)})


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def tools_runs(granite=None, hubert=None, llama=None, seq=TRAIN_SEQ,
               decode_len=None) -> dict:
    """Phase 18 (b)'s runs, each counted in (a) at its own cut:
    {label: (cfg, ShapeSpec, variant)}."""
    granite = granite or dataclasses.replace(get_config(ARCH),
                                             n_layers=TOOLS_LAYERS)
    hubert = hubert or dataclasses.replace(get_config(AUDIO),
                                           n_layers=TOOLS_LAYERS)
    llama = llama or get_config(LLAMA)
    train = ShapeSpec("train_4k", seq, TRAIN_BATCH, "train")
    decode = ShapeSpec("decode_32k",
                       decode_len or SHAPES["decode_32k"].seq_len,
                       DECODE_BATCH, "decode")
    runs = {f"granite_{v}": (granite, train, v) for v in GRANITE_VARIANTS}
    runs.update({f"llama_{v}": (llama, decode, v) for v in DECODE_VARIANTS})
    runs["hubert_baseline"] = (hubert, train, "baseline")
    return runs


def tools_train_case(cfg, sp, variant, dev="cuda", steps=TOOLS_STEPS):
    """Phase 18 (b): ``steps`` training steps (the first warm-up) of
    ``variant``'s real step, ``hillclimb.variant_steps`` over TOOLS_MESH
    virtual ranks on ``dev``, from seed 0 on ``sp``'s batches: per step its
    ms (host clock around a synchronized step), loss, grad norm, and the
    last step's collectives and bytes a rank; the launches of all steps."""
    _free(dev)
    mesh = make_test_mesh(*TOOLS_MESH, device=dev)
    vcfg, fns = hc_mod.variant_steps(cfg, mesh, variant)
    params = adamw.cast_params(M.init_params(
        vcfg, torch.Generator(device=dev).manual_seed(0), device=dev),
        vcfg.compute_dtype)
    state = adamw.init_opt_state(params)
    stream = SyntheticStream(DataConfig(vocab=vcfg.vocab,
                                        seq_len=sp.seq_len,
                                        global_batch=sp.global_batch))
    reset_launches()
    log = []
    for i in range(steps):
        batch = (av_batch(vcfg, sp.global_batch, sp.seq_len, dev, seed=i,
                          labels=True) if vcfg.family == "audio"
                 else stream.batch(i, dev))
        mesh.comm.stats.reset()
        _sync(dev)
        t = time.perf_counter()
        params, state, m = fns.train_step(params, state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        _sync(dev)
        log.append((1e3 * (time.perf_counter() - t), loss, gnorm))
    launches = read_launches()
    tc = {"gmm_swiglu": swiglu_mod.launches_tc, "gmm": gmm_mod.launches_tc,
          "gmm_swiglu_bwd": bwd_mod.launches_tc}
    out = {"arch": vcfg.name, "variant": variant, "n_layers": vcfg.n_layers,
           "batch": sp.global_batch, "seq": sp.seq_len, "kind": "train",
           "remat": vcfg.remat, "remat_policy": vcfg.remat_policy,
           "step_ms": [x[0] for x in log],
           "ms": statistics.median(x[0] for x in log[1:]),
           "losses": [x[1] for x in log], "grad_norms": [x[2] for x in log],
           "collectives": dict(mesh.comm.stats.counts),
           "comm_bytes_per_rank": mesh.comm.stats.bytes,
           "launches": launches, "tensor_core_launches": tc,
           "max_memory_allocated_bytes": _peak(dev)}
    del params, state, fns
    return out


def decode_cache(cfg, batch, max_len, steps, dev, seed=1):
    """A ``max_len``-slot cache of random keys and values, its length
    ``max_len - steps - 1``: room for a warm-up and ``steps`` steps."""
    cache = M.init_cache(cfg, batch, max_len, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for lc in cache:
        lc["k"].normal_(generator=gen)
        lc["v"].normal_(generator=gen)
        lc["len"] = torch.full_like(lc["len"], max_len - steps - 1)
    return cache


def tools_decode_case(cfg, sp, variant, dev="cuda", steps=DECODE_STEPS):
    """Phase 18 (b): one warm-up and ``steps`` decode steps of
    ``variant``'s real step over TOOLS_MESH virtual ranks on ``dev``,
    teacher-forced on seeded tokens from :func:`decode_cache`: per step its
    ms, the last step's collectives and bytes a rank, the launches. Returns
    the line and the logits of every step (on the host)."""
    _free(dev)
    mesh = make_test_mesh(*TOOLS_MESH, device=dev)
    vcfg, fns = hc_mod.variant_steps(cfg, mesh, variant)
    params = M.init_params(vcfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    B = sp.global_batch
    toks = torch.randint(0, vcfg.vocab, (steps + 1, B, 1), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    ms, logits = [], []
    with torch.no_grad():
        cache = decode_cache(vcfg, B, sp.seq_len, steps, dev)
        reset_launches()
        for i in range(steps + 1):
            mesh.comm.stats.reset()
            _sync(dev)
            t = time.perf_counter()
            lg, cache = fns.decode_step(params, toks[i], cache)
            _sync(dev)
            ms.append(1e3 * (time.perf_counter() - t))
            logits.append(lg.float().cpu())
    launches = read_launches()
    logits = torch.stack(logits)
    out = {"arch": vcfg.name, "variant": variant, "n_layers": vcfg.n_layers,
           "batch": B, "seq": sp.seq_len, "kind": "decode",
           "dtype": vcfg.dtype, "step_ms": ms,
           "ms": statistics.median(ms[1:]),
           "collectives": dict(mesh.comm.stats.counts),
           "comm_bytes_per_rank": mesh.comm.stats.bytes,
           "launches": launches,
           "logits_finite": bool(torch.isfinite(logits).all()),
           "max_memory_allocated_bytes": _peak(dev)}
    del params, cache, fns
    return out, logits


def decode_gap(a, b) -> dict:
    err, scale = float((a - b).abs().max()), float(b.abs().max())
    return {"max_abs_err": err, "logit_max_abs": scale,
            "of_max_logit": err / max(scale, 1e-30)}


def tools_decode_consistency(cfg=None, dev="cuda", max_len=None, steps=4):
    """Phase 18 (b): the two decode paths (flash decoding over the virtual
    ranks, and the dense one-token attention) on the same cache and
    tokens, fp32 at full width cut to PARITY_LAYERS layers, within
    FAMILY_TOL x max|logit| of each other; the flash path's three
    all-reduces a layer ran."""
    cfg = cfg or dataclasses.replace(get_config(LLAMA),
                                     n_layers=PARITY_LAYERS, dtype="float32")
    sp = ShapeSpec("decode_32k", max_len or SHAPES["decode_32k"].seq_len,
                   DECODE_BATCH, "decode")
    (fd, lf), (dense, ld) = (tools_decode_case(cfg, sp, v, dev, steps)
                             for v in DECODE_VARIANTS)
    out = dict(decode_gap(lf, ld), n_layers=cfg.n_layers, dtype=cfg.dtype,
               seq=sp.seq_len, batch=sp.global_batch, steps=steps,
               tol=FAMILY_TOL, flash_collectives=fd["collectives"],
               dense_collectives=dense["collectives"])
    if not (out["of_max_logit"] <= FAMILY_TOL
            and fd["collectives"] == {"all-reduce": 3 * cfg.n_layers}
            and not dense["collectives"]):
        raise AssertionError(f"the decode paths disagree: {out}")
    return out


def hillclimb_launches(run) -> dict:
    """The GMM launches a granite variant's run must make: per layer per
    step 2F ``gmm_swiglu``, 4F ``gmm`` and F ``gmm_swiglu_bwd`` (phase 14's
    formulas), or F, 3F and F where the MoE forward is not recomputed
    (remat off, or policy "save_moe")."""
    mode = "baseline" if run["variant"] == "ep_dp_baselinea2a" \
        else "hyperparallel"
    F = ep_bench.ffn_calls(mode, TOOLS_MESH[1], 1)
    again = run["remat"] and run["remat_policy"] != "save_moe"
    per = dict(TRAIN_LAUNCHES, gmm_swiglu=2 if again else 1,
               gmm=4 if again else 3)
    return {k: run["n_layers"] * len(run["step_ms"]) * F * n
            for k, n in per.items()}


def tools_check(runs, measured, results) -> dict:
    """Phase 18 (a) and (b) joined: each run beside its count at the same
    cut. Gates: the count did not fail; its collectives and bytes a rank
    equal the run's last step's; the share of the roofline, max(t_compute,
    t_memory) / the measured ms, at most SHARE_MAX; finite losses, grad
    norms and logits; granite's GMM launches as :func:`hillclimb_launches`
    (every one on the tensor cores), no launch elsewhere; baseline and
    zero1 bit-equal on the first step; the two EP modes' first step within
    LOSS_TOL (loss) and GNORM_TOL (grad norm)."""
    rows, bad = {}, []
    for (label, (cfg, sp, variant)), (row, fail) in zip(runs.items(),
                                                        results):
        run = measured[label]
        if fail is not None:
            bad.append(f"{label}: count failed {fail}")
            continue
        share = (max(row["t_compute_s"], row["t_memory_s"])
                 / (run["ms"] / 1e3))
        rows[label] = dict(run, tag=row["tag"], line=row["line"],
                           t_compute_ms=1e3 * row["t_compute_s"],
                           t_memory_ms=1e3 * row["t_memory_s"],
                           t_collective_ms=1e3 * row["t_collective_s"],
                           bottleneck=row["bottleneck"],
                           counted_collectives=row["collectives"],
                           counted_bytes_per_rank=row[
                               "collective_bytes_per_rank"],
                           roofline_share=share, count_s=row["count_s"])
        if (row["collectives"] != run["collectives"]
                or row["collective_bytes_per_rank"]
                != run["comm_bytes_per_rank"]):
            bad.append(f"{label}: counted collectives {row['collectives']}"
                       f" / {row['collective_bytes_per_rank']} B, ran "
                       f"{run['collectives']} / {run['comm_bytes_per_rank']}")
        if share > SHARE_MAX:
            bad.append(f"{label}: share {share:.3f} > {SHARE_MAX}")
        values = run.get("losses", []) + run.get("grad_norms", [])
        if not all(math.isfinite(v) for v in values) or \
                not run.get("logits_finite", True):
            bad.append(f"{label}: non-finite values")
        if label.startswith("granite_"):
            want = hillclimb_launches(run)
            tc = run["tensor_core_launches"]
            if run["launches"] != want or tc != {k: want[k] for k in tc}:
                bad.append(f"{label}: launches {run['launches']} (tensor "
                           f"cores {tc}) != {want}")
        elif any(run["launches"].values()):
            bad.append(f"{label}: launched {run['launches']}, no MoE")
    base, z1 = measured["granite_baseline"], measured["granite_zero1"]
    if base["losses"][0] != z1["losses"][0]:
        bad.append(f"baseline and zero1 first losses differ: "
                   f"{base['losses'][0]} != {z1['losses'][0]}")
    ring, a2a = (measured["granite_ep_dp"],
                 measured["granite_ep_dp_baselinea2a"])
    modes = {"loss_rel_gap": abs(ring["losses"][0] - a2a["losses"][0])
             / abs(a2a["losses"][0]),
             "grad_norm_rel_gap": abs(ring["grad_norms"][0]
                                      - a2a["grad_norms"][0])
             / a2a["grad_norms"][0]}
    if modes["loss_rel_gap"] > LOSS_TOL or \
            modes["grad_norm_rel_gap"] > GNORM_TOL:
        bad.append(f"the EP modes differ beyond their limits: {modes}")
    if bad:
        raise AssertionError(f"phase 18 failed its gates: {bad}")
    return {"runs": rows, "ep_modes": modes,
            "baseline_zero1_first_loss_bit_equal": True}


def tools_cells(results) -> list:
    """Phase 18 (a)'s lines: the three cells under TOOLS_CELL_VARIANTS at
    the reference's global batches, in ``hillclimb.CELLS`` order. Gates: no
    count failed; a MoE cell's every variant counts collectives (EP is on
    in each)."""
    rows, bad = [], []
    cells = [(name, arch, v) for name, (arch, _) in hc_mod.CELLS.items()
             for v in TOOLS_CELL_VARIANTS]
    for (name, arch, variant), (row, fail) in zip(cells, results):
        if fail is not None:
            bad.append(fail)
            continue
        rows.append({"cell": name, "variant": variant, **{k: row[k] for k in (
            "tag", "line", "t_compute_s", "t_memory_s", "t_collective_s",
            "bottleneck", "roofline_frac", "collectives",
            "collective_bytes_per_rank", "args_gb", "temp_gb", "count_s")}})
        if get_config(arch).family == "moe" and not row["collectives"]:
            bad.append((name, variant, "no collective counted"))
    if bad:
        raise AssertionError(f"phase 18 (a) failed: {bad}")
    return rows


def tools_examples(dev="cuda", quick_argv=(), explorer_argv=(),
                   serve_argv=(), e2e_argv=()) -> tuple:
    """Phase 18 (c): the four examples through their ``main`` on ``dev``
    (their output kept, its last lines printed in the phase's line), the
    SSC dump and checkpoints under ``tempfile``. Each must return; the MoE
    ones must launch the GMM kernels (quickstart's training and executor,
    serve_decode on granite's smoke config, train_moe_e2e), the others
    none. Returns the lines and each example's launches."""
    out, launches, bad = {}, {}, []
    with tempfile.TemporaryDirectory() as d:
        cases = (
            ("quickstart", ex_quickstart.main, list(quick_argv),
             ("gmm_swiglu", "gmm", "gmm_swiglu_bwd")),
            ("schedule_explorer", ex_explorer.main,
             ["--dump", os.path.join(d, "ssc_rank0.json"),
              *explorer_argv], ()),
            ("serve_decode", ex_serve.main, list(serve_argv), ()),
            ("serve_decode_moe", ex_serve.main,
             ["--arch", ARCH, *serve_argv], ("gmm_swiglu", "gmm")),
            ("train_moe_e2e", ex_e2e.main,
             ["--steps", str(E2E_STEPS), "--log-every", "1",
              "--ckpt-dir", os.path.join(d, "e2e"), *e2e_argv],
             ("gmm_swiglu", "gmm", "gmm_swiglu_bwd")))
        for name, fn, argv, kernels in cases:
            _free(dev)
            reset_launches()
            buf = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                res = fn(["--device", dev, *argv])
            n = read_launches()
            launches[name] = n
            out[name] = {"seconds": time.perf_counter() - t,
                         "launches": n,
                         "output_tail": buf.getvalue().splitlines()[-4:]}
            if name == "train_moe_e2e":
                out[name].update(steps=res.step, losses=[
                    m["loss"] for m in res.metrics_log],
                    saves=sum(r["op"] == "save" for r in res.ckpt_log))
                if res.step != E2E_STEPS or not all(
                        math.isfinite(x) for x in out[name]["losses"]):
                    bad.append((name, out[name]))
            if any(n[k] == 0 for k in kernels) or (
                    not kernels and any(n.values())):
                bad.append((name, n))
    if bad:
        raise AssertionError(f"phase 18 (c) failed: {bad}")
    return out, launches


def run_tools():
    """Phase 18. The decode runs first (host-bound: nothing beside them),
    then the counts of (a) in TOOLS_WORKERS spawned processes beside the
    device-bound training runs, then the examples. Returns the phase's
    line and the launches of paths tools_hillclimb (granite's variants),
    tools_quickstart, tools_serve_decode and tools_train_moe_e2e."""
    t0 = time.perf_counter()
    runs = tools_runs()
    measured, logits = {}, {}
    consistency = tools_decode_consistency()
    for label, (cfg, sp, variant) in runs.items():
        if sp.kind == "decode":
            measured[label], logits[label] = tools_decode_case(cfg, sp,
                                                               variant)
    bf16_gap = decode_gap(*(logits[f"llama_{v}"] for v in DECODE_VARIANTS))
    del logits
    cells = [(get_config(arch), shape, v, TOOLS_MESH)
             for arch, shape in hc_mod.CELLS.values()
             for v in TOOLS_CELL_VARIANTS]
    jobs = cells + [(cfg, sp, v, TOOLS_MESH) for cfg, sp, v in runs.values()]
    with ThreadPoolExecutor(1) as pool:
        t_count = time.perf_counter()
        fut = pool.submit(dryrun_mod.count_all, jobs, TOOLS_WORKERS,
                          hc_mod.count_job)
        for label, (cfg, sp, variant) in runs.items():
            if sp.kind == "train":
                measured[label] = tools_train_case(cfg, sp, variant)
        results = fut.result()
        count_s = time.perf_counter() - t_count
    _free()
    joined = tools_check(runs, measured, results[len(cells):])
    examples, ex_launches = tools_examples()
    hill = {k: sum(measured[f"granite_{v}"]["launches"][k]
                   for v in GRANITE_VARIANTS) for k in COUNTERS}
    return ({"phase": "tools", "mesh": list(TOOLS_MESH),
             "cells": tools_cells(results[:len(cells)]),
             "count_seconds": count_s, "count_workers": TOOLS_WORKERS,
             **joined, "decode_consistency": consistency,
             "decode_bf16_gap": dict(bf16_gap, note="printed, not gated"),
             "examples": examples, "seconds": time.perf_counter() - t0},
            {"tools_hillclimb": hill,
             "tools_quickstart": ex_launches["quickstart"],
             "tools_serve_decode": ex_launches["serve_decode_moe"],
             "tools_train_moe_e2e": ex_launches["train_moe_e2e"]})


def dist_virtual_case(cfg, mode, dev="cuda", seq=TRAIN_SEQ):
    """Phase 19's yardstick: one step of the one-process run over virtual
    ranks at the same mesh on the global batch: its loss and each leaf's
    grad norm (before clipping)."""
    dev = torch.device(dev)
    seen = {}

    def keep(g):
        seen["norms"] = [float(t.float().norm()) for t in adamw.tree_leaves(g)]
        return g
    mesh = make_mesh(DIST_MESH, dev)
    step = steps_mod.make_steps(
        cfg, mesh, opt=adamw.OptConfig(lr=1e-3, warmup_steps=2,
                                       total_steps=DIST_STEPS),
        ep=EPConfig(capacity_factor=EP_CF), mode=mode,
        grad_transform=keep).train_step
    params = adamw.cast_params(M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev),
        cfg.compute_dtype)
    batch = SyntheticStream(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=DIST_BATCH)).sharded_batch(
        0, mesh, dev)
    _, _, m = step(params, adamw.init_opt_state(params), batch)
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "grad_leaf_norms": seen["norms"]}
    del params, step, batch, m
    _free(dev)
    return out


def dist_expected_opt_bytes(cfg, mode, fsdp=None) -> int:
    """A rank's optimizer-state bytes by its ``opt_state_spec`` blocks:
    fp32 m, v and master of each leaf's block (every rank's blocks have
    one shape)."""
    rules = sharding.ShardingRules(cfg, _ShapeMesh(DIST_MESH), mode=mode,
                                   fsdp=fsdp)
    meta = adamw.cast_params(M.init_params(cfg, device="meta"),
                             cfg.compute_dtype)
    return sum(3 * 4 * math.prod(sharding.block_shape(t.shape, spec,
                                                       rules.mesh))
               for t, spec in zip(adamw.tree_leaves(meta),
                                  sharding.opt_state_specs(rules, meta)))


def dist_expected_params(cfg, mode, fsdp=None) -> tuple:
    """(params, bytes) of a rank's param blocks by its ``param_spec``, in
    the launcher's compute dtype."""
    rules = sharding.ShardingRules(cfg, _ShapeMesh(DIST_MESH), mode=mode,
                                   fsdp=fsdp)
    meta = adamw.cast_params(M.init_params(cfg, device="meta"),
                             cfg.compute_dtype)
    n = b = 0
    for t, spec in zip(adamw.tree_leaves(meta),
                       sharding.param_specs(rules, meta)):
        k = math.prod(sharding.block_shape(t.shape, spec, rules.mesh))
        n, b = n + k, b + k * t.element_size()
    return n, b


class _ShapeMesh:
    def __init__(self, dims):
        names = ("pod", "data", "model")[-len(dims):]
        self.shape = dict(zip(names, dims))
        self.axis_names = names


def dist_restore_check(cfg, mode, step_dir, ranks, fsdp=None) -> dict:
    """The processes' checkpoint restored in this process (on the host),
    each rank's block of every leaf cut from it: its CRC32 must equal the
    one that rank took of its own block at the end of its run."""
    rules = sharding.ShardingRules(cfg, _ShapeMesh(DIST_MESH), mode=mode,
                                   fsdp=fsdp)
    meta = adamw.cast_params(M.init_params(cfg, device="meta"),
                             cfg.compute_dtype)
    params = adamw.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                            meta)
    state = adamw.init_opt_state(params)
    t0 = time.perf_counter()
    JaxTrainLayout.restore(step_dir, params, state)
    restore_s = time.perf_counter() - t0
    specs = {"params": sharding.param_specs(rules, meta)}
    specs.update({k: sharding.opt_state_specs(rules, meta)
                  for k in ("m", "v", "master")})
    trees = {"params": params, **{k: state[k] for k in ("m", "v",
                                                       "master")}}
    unequal, blocks = [], 0
    for kind, tree in trees.items():
        for i, (t, spec) in enumerate(zip(adamw.tree_leaves(tree),
                                          specs[kind])):
            crcs = {}
            for r in ranks:
                c = r["coords"]
                key = tuple(c[a] for a in sharding.spec_axes(spec))
                if key not in crcs:
                    blk = sharding.local_block(t, spec, rules.mesh, c)
                    crcs[key] = train_mod._crc32([blk])[0]
                    blocks += 1
                if crcs[key] != r["state_crc32"][kind][i]:
                    unequal.append((kind, i, r["rank"]))
    out = {"step": state["step"], "restore_s": restore_s,
           "blocks_checked": blocks, "blocks_unequal": unequal}
    if unequal or state["step"] != DIST_STEPS:
        raise AssertionError(f"the processes' checkpoint does not restore "
                             f"to their blocks: {out}")
    return out


def _nccl_try(rank, init, out_dir):
    import torch.distributed as dist
    try:
        dist.init_process_group("nccl", init_method=init, world_size=2,
                                rank=rank)
        t = torch.ones(1, device="cuda:0")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        msg = "no error"
    except Exception as e:      # the refusal is what this try records
        msg = f"{type(e).__name__}: {e}"
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"nccl{rank}.txt"), "w") as f:
        f.write(msg)


def nccl_try_start():
    """Start two NCCL ranks on the one card (``nccl_refusal`` reads what
    NCCL said)."""
    import torch.multiprocessing as mp
    d = tempfile.mkdtemp()
    return d, mp.start_processes(_nccl_try, args=(f"file://{d}/init", d),
                                 nprocs=2, join=False, start_method="spawn")


def nccl_refusal(started, timeout_s=60) -> dict:
    """NCCL's own refusal of two ranks on the one card, read from each
    process (killed if it has not ended ``timeout_s`` after this call)."""
    d, ctx = started
    try:
        t0, ended = time.perf_counter(), None
        try:
            while not ctx.join(timeout=1):
                if time.perf_counter() - t0 > timeout_s:
                    ended = f"killed after {timeout_s} s"
                    break
        except Exception as e:      # a rank NCCL ended by a signal
            ended = f"{type(e).__name__}: {e}"
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        msgs = []
        for r in range(2):
            path = os.path.join(d, f"nccl{r}.txt")
            msgs.append(open(path).read() if os.path.exists(path)
                        else "no message (killed)")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return {"ranks": 2, "device": "cuda:0", "messages": msgs,
            "ended": ended}


def dist_config(smoke=False):
    """Phases 19 and 20's model: granite cut to DIST_LAYERS layers (the
    smoke config's widths with ``smoke``), its experts padded for
    DIST_MESH's model axis."""
    base = dataclasses.replace(
        get_smoke_config(ARCH) if smoke else get_config(ARCH),
        n_layers=DIST_LAYERS)
    return train_mod.pad_experts(base, DIST_MESH[-1])


def dist_launches_per_step() -> dict:
    """A process's GMM launches a step: one rank's ring makes an FFN call
    at each of its ep steps, TRAIN_LAUNCHES a layer a step."""
    F = DIST_MESH[-1]
    return {k: DIST_LAYERS * F * n for k, n in TRAIN_LAUNCHES.items() if n}


def dist_runs(pcfg, cases, *, smoke=False, dev="cuda", seq=TRAIN_SEQ):
    """Runs of phases 19, 19b and 20 (a): ``launch.train --nproc DIST_PROCS
    --backend gloo``, one a case (a dict of ``dist_run_case``'s keywords:
    ``mode``, ``want``, ``fsdp``, ``ckpt``, ``dropless``), all in one spawn
    of the processes (``train.main_runs``), each held by ``dist_run_case``.
    Returns (the spawn's seconds, each case's (row, each process's
    launches))."""
    argvs = []
    for c in cases:
        argvs.append(["--arch", ARCH, "--nproc", str(DIST_PROCS), "--mesh",
                      "x".join(map(str, DIST_MESH)), "--mode", c["mode"],
                      "--backend", "gloo", "--device", dev, "--seq",
                      str(seq), "--global-batch", str(DIST_BATCH),
                      "--steps", str(DIST_STEPS), "--lr", "1e-3",
                      "--n-layers", str(DIST_LAYERS)]
                     + (["--smoke"] if smoke else [])
                     + (["--dropless"] if c.get("dropless") else []))
        if c.get("ckpt") is not None:     # one checkpoint, at the end
            argvs[-1] += ["--ckpt-dir", c["ckpt"], "--ckpt-every",
                          str(DIST_STEPS)]
    t = time.perf_counter()
    runs = train_mod.main_runs(argvs, fsdp=[c.get("fsdp") for c in cases])
    wall = time.perf_counter() - t
    return wall, [dist_run_case(pcfg, run, dev=dev, seq=seq, **c)
                  for c, run in zip(cases, runs)]


def dist_run_case(pcfg, run, *, mode, want, dev="cuda", seq=TRAIN_SEQ,
                  fsdp=None, ckpt=None, dropless=False):
    """One run of ``dist_runs`` (``run``, its ``TrainRun``) in ``mode``
    (``fsdp``: ``train.main(fsdp=)``), held to ``want``
    (``dist_virtual_case``, or phase 19b's ``dist_dropless_case``), its
    processes' params and state to their spec blocks, their launches to
    ``dist_launches_per_step`` (``dropless``: ``--dropless``,
    ``dist_dropless_check``); with ``ckpt`` (a directory) its last step
    saved there, and the restore is checked. Returns (the run's row, each
    process's launches)."""
    cuda = torch.device(dev).type == "cuda"
    names = ["/".join(map(str, p)) for p, _, _ in
             sharding.jax_leaves(M.init_params(pcfg, device="meta"))]
    per_step = None if dropless else dist_launches_per_step()
    log, ranks = run.metrics_log, run.ranks
    if not all(math.isfinite(m["loss"])
               and math.isfinite(m["grad_norm"]) for m in log):
        raise AssertionError(f"{mode}: non-finite metrics {log}")
    got = log[0]
    loss_gap = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    norm_gap = max(abs(a - b) / max(b, 1e-30) for a, b in zip(
        got["grad_leaf_norms"], want["grad_leaf_norms"],
        strict=True))
    launches = [dict(r["launches"]) for r in ranks]
    tc = [r.pop("tensor_cores") for r in launches]
    opt_bytes = dist_expected_opt_bytes(pcfg, mode, fsdp)
    n_params, param_bytes = dist_expected_params(pcfg, mode, fsdp)
    step_ms = [m["step_ms"] for m in log]
    row = {
        "seconds": ranks[0]["seconds"], "losses": [m["loss"] for m in log],
        "grad_norms": [m["grad_norm"] for m in log],
        "step_ms": step_ms,
        "step_ms_median_after_warmup": statistics.median(
            step_ms[1:]),
        "tokens_per_s": DIST_BATCH * seq / (statistics.median(
            step_ms[1:]) / 1e3),
        "virtual": {k: want[k] for k in ("loss", "grad_norm")},
        "loss_rel_gap": loss_gap,
        "grad_leaf_norm_rel_gap_max": norm_gap,
        "grad_leaf_norms": {n: [a, b] for n, a, b in sorted(
            zip(names, got["grad_leaf_norms"],
                want["grad_leaf_norms"]),
            key=lambda x: -abs(x[1] - x[2]) / max(x[2], 1e-30))[:4]},
        "collectives_per_rank_per_step": log[-1]["collectives"],
        "comm_bytes_per_rank_per_step":
            log[-1]["comm_bytes_per_rank"],
        # Rank 0's host seconds in each kind of transfer, the
        # backward's included, a step after the warm-up.
        "comm_s_per_step": [m["comm_seconds"] for m in log[1:]],
        "peak_bytes_per_process": [r["peak_bytes"] for r in ranks],
        "params_per_process_by_spec": n_params,
        "param_bytes_per_process": [r["param_bytes"] for r in ranks],
        "param_bytes_by_spec": param_bytes,
        "opt_state_bytes_per_process": [r["opt_state_bytes"]
                                        for r in ranks],
        "opt_state_bytes_by_spec": opt_bytes,
        "launches_per_process": launches,
        "launches_per_process_per_step": per_step,
        "tensor_core_launches_per_process": tc,
        "ckpt": ranks[0]["ckpt_log"]}
    if loss_gap > LOSS_TOL or norm_gap > GNORM_TOL:
        raise AssertionError(f"{mode}: beyond the virtual ranks' "
                             f"run: {row}")
    if any(b != opt_bytes for b in row["opt_state_bytes_per_process"]) \
            or any(b != param_bytes for b in row["param_bytes_per_process"]):
        raise AssertionError(f"{mode}: params or optimizer state are not "
                             f"the spec's blocks: {row}")
    if dropless:
        row.update(dist_dropless_check(mode, ranks, launches, tc, want,
                                       cuda, pcfg.moe.n_experts))
    else:
        want_l = {k: DIST_STEPS * n for k, n in per_step.items()}
        if cuda and any(
                {k: r[k] for k in want_l} != want_l
                or t != {k: want_l[k] for k in t}
                for r, t in zip(launches, tc)):
            raise AssertionError(f"{mode}: launches {launches} (tensor "
                                 f"cores {tc}) != {want_l} a process")
    if ckpt is not None:
        row["restore"] = dist_restore_check(
            pcfg, mode, ckpt_mod.latest_step_dir(ckpt), ranks, fsdp)
        shutil.rmtree(ckpt, ignore_errors=True)
    return row, launches


def run_dist_train(smoke=False, dev="cuda", seq=TRAIN_SEQ, nccl=True):
    """Phase 19: ``launch.train --nproc DIST_PROCS --backend gloo
    --n-layers DIST_LAYERS`` on the one card (or ``dev``; ``smoke``: at the
    smoke config's widths), granite at full width cut to DIST_LAYERS
    layers, mesh DIST_MESH, zero1 then ep_dp. Returns the phase's line and
    the launches of path dist_train (every process's, summed)."""
    t_phase = time.perf_counter()
    pcfg = dist_config(smoke)
    total = {k: 0 for k in COUNTERS}
    modes, root = {}, tempfile.mkdtemp()
    # NCCL's try runs beside the modes: it fails at its first collective.
    started = nccl_try_start() if nccl else None
    try:
        cases = [dict(mode=mode, want=dist_virtual_case(pcfg, mode, dev, seq),
                      ckpt=(os.path.join(root, mode)
                            if mode == DIST_MODES[-1] else None))
                 for mode in DIST_MODES]
        spawn_s, rows = dist_runs(pcfg, cases, smoke=smoke, dev=dev,
                                  seq=seq)
        for c, (row, launches) in zip(cases, rows):
            for k in COUNTERS:
                total[k] += sum(r.get(k, 0) for r in launches)
            modes[c["mode"]] = row
    finally:
        shutil.rmtree(root, ignore_errors=True)
        # Reaps the two NCCL ranks whatever happened above.
        refusal = None if started is None else nccl_refusal(started)
    out = {"phase": "dist_train", "arch": ARCH, "n_layers": DIST_LAYERS,
           "processes": DIST_PROCS, "mesh": list(DIST_MESH),
           "backend": "gloo (host-staged: one card)", "device": dev,
           "seq": seq, "global_batch": DIST_BATCH, "steps": DIST_STEPS,
           "capacity_factor": EP_CF, "loss_tol": LOSS_TOL,
           "grad_norm_tol": GNORM_TOL, "modes": modes,
           "spawn_wall_s": spawn_s}
    if refusal is not None:
        out["nccl_two_ranks_one_card"] = refusal
    out["seconds"] = time.perf_counter() - t_phase
    return out, total


def _gmm_step(rec) -> list:
    """A step record's ``gmm`` launches: [all, fp32 tiled, narrow,
    small-row]."""
    fp32 = rec["gmm_fp32_launches"]
    return [rec["gmm_launches"], fp32["tiled"], fp32["narrow"],
            fp32["small"]]


def dist_dropless_check(mode, ranks, launches, tc, want, cuda,
                        e_real) -> dict:
    """Phase 19b's gates on the processes' records beyond phase 19's:
    every process 2 x layers SSC lookups a step (``want``'s), all misses
    on step 0; on the card each process's ``gmm`` launches a step, all on
    the fp32 bodies, equal every other process's (each runs one fragment
    on one whole batch), FRAGMENT_GMM_PER_EXPERT for each expert of each
    layer that the step routes a token to (at most ``e_real``, the
    experts that are not padding), and no other kernel, no tensor core.
    The one-process step's launches are printed beside: its bf16 routing
    may differ at a near tie, and a rarely routed expert's tiles with it
    (8 launches more in tp_sp's step 0 on an H100 80GB HBM3, 700 W).
    Returns the row's additions; raises otherwise."""
    steps = [r["per_step"] for r in ranks]
    gmm = [[_gmm_step(s) for s in st] for st in steps]
    out = {"ssc_per_process": [[{k: v for k, v in s.items()
                                 if k.startswith("ssc_")} for s in st]
                               for st in steps],
           "gmm_per_process_per_step": gmm,
           "one_process_gmm": want["gmm"],
           "step0_gmm_equals_one_process": gmm[0][0] == want["gmm"][0]}
    lookups = [[s["ssc_hits"] + s["ssc_misses"] for s in st] for st in steps]
    bad = []
    if any(n != want["ssc_lookups"] for st in lookups for n in st) or any(
            st[0]["ssc_hits"] for st in steps):
        bad.append(f"SSC lookups a step {lookups}, want "
                   f"{want['ssc_lookups']} (step 0 all misses)")
    most = FRAGMENT_GMM_PER_EXPERT * DIST_LAYERS * e_real
    if cuda and (any(g != gmm[0] for g in gmm) or any(
            n != tiled + narrow + small or n % FRAGMENT_GMM_PER_EXPERT
            or not 0 < n <= most for n, tiled, narrow, small in gmm[0])):
        bad.append(f"gmm launches a step [all, tiled, narrow, small] "
                   f"{gmm}: want "
                   f"them equal, on the fp32 bodies, "
                   f"{FRAGMENT_GMM_PER_EXPERT} a routed expert a layer "
                   f"(at most {most})")
    if cuda and any(v for r in launches for k, v in r.items()
                    if k in COUNTERS and k != "gmm") or any(
                        any(t.values()) for t in tc):
        bad.append(f"other kernels {launches} (tensor cores {tc})")
    if bad:
        raise AssertionError(f"{mode}: {bad}")
    return out


def dist_dropless_case(cfg, dev="cuda", seq=DROPLESS_DIST_SEQ):
    """Phase 19b's yardstick: the one-process dropless step
    (``make_train_step(cfg, dropless=DroplessConfig(ep=DIST_MESH[-1]))``,
    the launcher's optimizer) on the launcher's first global batch from
    the same params: its loss and each leaf's grad norm (before clipping),
    its ``gmm`` launches ([all, fp32 tiled, narrow, small-row]) and SSC
    lookups."""
    dev = torch.device(dev)
    seen = {}

    def keep(g):
        seen["norms"] = [float(t.float().norm()) for t in adamw.tree_leaves(g)]
        return g
    step = steps_mod.make_train_step(
        cfg, adamw.OptConfig(lr=1e-3, warmup_steps=2,
                             total_steps=DIST_STEPS),
        dropless=dropless_mod.DroplessConfig(ep=DIST_MESH[-1]),
        grad_transform=keep)
    params = adamw.cast_params(M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev),
        cfg.compute_dtype)
    reset_launches()
    _, _, m = step(params, adamw.init_opt_state(params),
                   SyntheticStream(DataConfig(
                       vocab=cfg.vocab, seq_len=seq,
                       global_batch=DIST_BATCH)).batch(0, dev))
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "grad_leaf_norms": seen["norms"],
           "gmm": [[gmm_mod.launches, gmm_mod.launches_fp32_tiled,
                    gmm_mod.launches_fp32_narrow,
                    gmm_mod.launches_fp32_small]],
           "ssc": {k: v for k, v in m.items() if k.startswith("ssc_")},
           "ssc_lookups": 2 * cfg.n_layers}
    del params, step, m
    _free(dev)
    return out


def run_dist_dropless(smoke=False, dev="cuda", seq=DROPLESS_DIST_SEQ):
    """Phase 19b: ``launch.train --nproc DIST_PROCS --backend gloo
    --dropless`` in each of DROPLESS_DIST_MODES, granite at full width cut
    to DIST_LAYERS layers (``smoke``: the smoke config's widths), held to
    the one-process dropless step (``dist_dropless_case``). Returns the
    phase's line and the launches of path dist_dropless (every process's,
    summed)."""
    t_phase = time.perf_counter()
    pcfg = dist_config(smoke)
    t = time.perf_counter()
    want = dist_dropless_case(pcfg, dev, seq)
    want["seconds"] = time.perf_counter() - t
    total = {k: 0 for k in COUNTERS}
    modes = {}
    spawn_s, rows = dist_runs(pcfg, [
        dict(mode=mode, want=want, dropless=True)
        for mode in DROPLESS_DIST_MODES], smoke=smoke, dev=dev, seq=seq)
    for mode, (row, launches) in zip(DROPLESS_DIST_MODES, rows):
        for k in COUNTERS:
            total[k] += sum(r.get(k, 0) for r in launches)
        modes[mode] = row
    out = {"phase": "dist_dropless", "arch": ARCH, "n_layers": DIST_LAYERS,
           "remat": pcfg.remat, "processes": DIST_PROCS,
           "mesh": list(DIST_MESH),
           "backend": "gloo (host-staged: one card)", "device": dev,
           "seq": seq, "global_batch": DIST_BATCH, "steps": DIST_STEPS,
           "dropless_ep": DIST_MESH[-1], "loss_tol": LOSS_TOL,
           "grad_norm_tol": GNORM_TOL, "one_process": want,
           "modes": modes, "spawn_wall_s": spawn_s,
           "seconds": time.perf_counter() - t_phase}
    return out, total


def run_dist_tp(smoke=False, dev="cuda", seq=TRAIN_SEQ):
    """Phase 20: tp_sp across processes, phase 19's setup run in mode
    tp_sp without and with FSDP (``DIST_TP_RUNS``), each held to the one
    one-process tp_sp run over virtual ranks at the same mesh (FSDP and
    the residual's placement change no value there), then (b) the other
    families (``run_dist_families``). Returns the phase's line and the
    launches of path dist_tp (every process's, summed)."""
    t_phase = time.perf_counter()
    pcfg = dist_config(smoke)
    total = {k: 0 for k in COUNTERS}
    runs, root = {}, tempfile.mkdtemp()
    try:
        want = dist_virtual_case(pcfg, "tp_sp", dev, seq)
        last = list(DIST_TP_RUNS)[-1]
        spawn_s, rows = dist_runs(pcfg, [
            dict(mode="tp_sp", want=want, fsdp=fsdp,
                 ckpt=os.path.join(root, name) if name == last else None)
            for name, fsdp in DIST_TP_RUNS.items()], smoke=smoke, dev=dev,
            seq=seq)
        for (name, fsdp), (row, launches) in zip(DIST_TP_RUNS.items(), rows):
            row["fsdp"] = fsdp
            for k in COUNTERS:
                total[k] += sum(r.get(k, 0) for r in launches)
            runs[name] = row
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _free(dev)
    t_fam = time.perf_counter()
    families, fam_launches = run_dist_families(smoke, dev, seq)
    families["seconds"] = time.perf_counter() - t_fam
    for k in COUNTERS:
        total[k] += fam_launches[k]
    out = {"phase": "dist_tp", "arch": ARCH, "n_layers": DIST_LAYERS,
           "processes": DIST_PROCS, "mesh": list(DIST_MESH),
           "backend": "gloo (host-staged: one card)", "device": dev,
           "seq": seq, "global_batch": DIST_BATCH, "steps": DIST_STEPS,
           "capacity_factor": EP_CF, "loss_tol": LOSS_TOL,
           "grad_norm_tol": GNORM_TOL, "runs": runs, "spawn_wall_s": spawn_s,
           "families": families, "seconds": time.perf_counter() - t_phase}
    return out, total


def dist_family_config(arch, smoke=False):
    """Phase 20 (b)'s model of ``arch``: full width (the smoke config's with
    ``smoke``) cut to its DIST_FAMILIES layers."""
    base = get_smoke_config(arch) if smoke else get_config(arch)
    return dataclasses.replace(base, n_layers=DIST_FAMILIES[arch][0])


def dist_family_batch(cfg, seq, step, dev):
    """The global batch of ``step``: DIST_BATCH x ``seq`` tokens of the
    synthetic stream, or (vlm, audio) ``av_batch``'s tokens and patches or
    frames with labels, drawn from the step."""
    if cfg.family in ("vlm", "audio"):
        return av_batch(cfg, DIST_BATCH, seq, dev, seed=step, labels=True)
    return SyntheticStream(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=DIST_BATCH)).batch(
        step, dev)


def _family_params(cfg, dev):
    return adamw.cast_params(M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev),
        cfg.compute_dtype)


def _ssd_probe(terms):
    """``models.ssm._ssd_chunked`` with a probe s (ones) on each call's log
    decay la = dt·A: it runs on x/s and dt·s, so dt·x and, with the D term
    put back, its output keep their values, and ∂L/∂s is c = ∂L/∂la · la,
    whose sum over rows and positions is ``A_log``'s grad (ROADMAP §3,
    ``tests/_torch_families.ssd_gradient_terms``). Appends each call's s."""
    from repro_torch.models import ssm as ssm_mod
    orig = ssm_mod._ssd_chunked

    def probed(x, dt, A, B_, C_, D, chunk):
        s = torch.ones(dt.shape, dtype=dt.dtype, device=dt.device,
                       requires_grad=True)
        terms.append(s)
        y, st = orig(x / s[..., None], dt * s, A, B_, C_, D, chunk)
        return y + (x - x / s[..., None]) * D[None, None, :, None], st
    return probed


def dist_family_virtual(cfg, dev, seq, fp32=False):
    """Phase 20 (b)'s yardstick: step 0 in one process over DIST_MESH
    virtual ranks, each data group's program on its rows in turn (the
    model axis places nothing for these families in one process), on the
    processes' params and inputs, in their dtype or with ``fp32`` in fp32:
    the mean of the groups' losses and each leaf's grad norm (before
    clipping) of the mean of their grads (summed in fp32). An ssm's
    ``A_log`` grad is a cancelling sum of terms c (each layer's,
    ``_ssd_probe``; its run without remat, which changes no value):
    ``a_log_scale`` is the norm over the heads of Σ|c|, the size its gap is
    held to, as ROADMAP §3's rule holds it."""
    from repro_torch.models import ssm as ssm_mod
    dt = torch.float32 if fp32 else cfg.compute_dtype
    params = adamw.tree_map(lambda t: t.to(dt), _family_params(cfg, dev))
    batch = {k: v.to(dt) if v.is_floating_point() else v
             for k, v in dist_family_batch(cfg, seq, 0, dev).items()}
    ssm = cfg.family == "ssm"
    cfg = dataclasses.replace(cfg, dtype="float32" if fp32 else cfg.dtype,
                              remat=cfg.remat and not ssm)
    groups = DIST_MESH[0]
    rows = DIST_BATCH // groups
    loss, grads, abs_terms = 0.0, None, None
    orig = ssm_mod._ssd_chunked
    for g in range(groups):
        part = {k: v[g * rows:(g + 1) * rows] for k, v in batch.items()}
        terms = []
        if ssm:
            ssm_mod._ssd_chunked = _ssd_probe(terms)
        try:
            leaves = adamw.tree_leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            lv = M.loss_fn(cfg, params, part)
            gr = torch.autograd.grad(lv, leaves + terms, allow_unused=True)
        finally:
            ssm_mod._ssd_chunked = orig
        loss += float(lv.detach()) / groups
        gl = [torch.zeros_like(p) if t is None else t.float() / groups
              for p, t in zip(leaves, gr)]
        grads = gl if grads is None else [a + b for a, b in zip(grads, gl)]
        c = [t.abs().sum((0, 1)) / groups for t in gr[len(leaves):]]
        abs_terms = c if abs_terms is None else [
            a + b for a, b in zip(abs_terms, c)]
        del gr, gl, lv
    out = {"loss": loss, "grad_leaf_norms": [float(t.norm())
                                             for t in grads],
           "a_log_scale": [float(t.norm()) for t in abs_terms]}
    del params, grads, batch
    _free(dev)
    return out


def _dist_family_rank(rank, init, out_dir, smoke, dev, seq):
    """One process of phase 20 (b): every DIST_FAMILIES run in turn, each
    DIST_FAMILY_STEPS steps of ``make_steps(mode="tp_sp")`` on its block of
    the params and of each step's batch (``sharding.batch_block``), then
    phase 20 (c)'s serving layouts (``serve_ranks``, held to the
    yardsticks in ``out_dir``); its record to ``out_dir``."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=init,
                            world_size=DIST_PROCS, rank=rank)
    try:
        dev = torch.device(dev)
        if dev.type == "cuda":
            dev = torch.device("cuda", 0)     # every rank on the one card
            torch.cuda.set_device(dev)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // DIST_PROCS))
        mesh = dist_mesh(DIST_MESH)
        out = {}
        for arch, (_, fsdp) in DIST_FAMILIES.items():
            cfg = dist_family_config(arch, smoke)
            fns = steps_mod.make_steps(
                cfg, mesh, opt=adamw.OptConfig(
                    lr=1e-3, warmup_steps=2, total_steps=DIST_FAMILY_STEPS),
                mode="tp_sp", fsdp=fsdp)
            params = sharding.own_params(fns.rules, _family_params(cfg, dev),
                                         mesh)
            state = adamw.init_opt_state(params, fns.rules, mesh)
            _free(dev)
            reset_launches()
            log = []
            for step in range(DIST_FAMILY_STEPS):
                batch = sharding.batch_block(
                    fns.rules, dist_family_batch(cfg, seq, step, dev), mesh)
                mesh.comm.stats.reset()
                _sync(dev)
                t = time.perf_counter()
                params, state, m = fns.train_step(params, state, batch)
                _sync(dev)
                stats = mesh.comm.stats
                log.append({"loss": float(m["loss"]),
                            "grad_norm": float(m["grad_norm"]),
                            "grad_leaf_norms": m["grad_leaf_norms"].tolist(),
                            "step_ms": 1e3 * (time.perf_counter() - t),
                            "collectives": dict(stats.counts),
                            "comm_bytes": stats.bytes,
                            "comm_seconds": dict(stats.seconds)})
            out[arch] = {
                "log": log, "launches": read_launches(),
                "param_bytes": tree_bytes(params),
                "opt_state_bytes": sum(tree_bytes(state[k])
                                       for k in ("m", "v", "master")),
                "peak_bytes": _peak(dev),
                "peak_reserved_bytes": (torch.cuda.max_memory_reserved()
                                        if dev.type == "cuda" else None)}
            del params, state, fns, batch, m
            _free(dev)
        out["serve"] = serve_ranks(mesh, dev, smoke, torch.load(
            os.path.join(out_dir, "serve_want.pt"), weights_only=False))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dist_family_gaps(cfg, got, want) -> dict:
    """Step 0 of a phase 20 (b) run (``got``: rank 0's record) against its
    yardsticks (``want``): the loss's relative gap and each reduced grad
    leaf's norm's gap from the one-process bf16 run's, relative to that
    norm (an ssm layer's ``A_log``: to the size of its grad's terms), the
    largest three named with the fp32 run's norm beside them; and for
    DIST_FP32_ARCHS the same gaps of the one-process bf16 run from the fp32
    one, what bf16 itself resolves (mamba2's SSD runs in bf16, as the
    reference's does; None for the others)."""
    names = [f"{i}:{'/'.join(map(str, p))}" for i, (p, _, _) in enumerate(
        sharding.jax_leaves(M.init_params(cfg, device="meta")))]
    w16, w32 = want["bf16"], want["fp32"] or want["bf16"]

    def scales(w):
        out, a_log = list(w["grad_leaf_norms"]), iter(w["a_log_scale"])
        for i, n in enumerate(names):
            if n.endswith("/A_log"):
                out[i] = next(a_log)
        return out

    def rel(a, b, c):
        return abs(a - b) / max(c, 1e-30)

    def leaf_gaps(a, b, c):
        return [rel(*x) for x in zip(a["grad_leaf_norms"],
                                     b["grad_leaf_norms"], c, strict=True)]
    gaps = leaf_gaps(got, w16, scales(w16))
    own = leaf_gaps(w16, w32, scales(w32))
    worst = sorted(range(len(names)), key=lambda i: -gaps[i])[:3]
    fp32 = want["fp32"] is not None
    return {"yardstick_loss": w16["loss"],
            "loss_rel_gap": rel(got["loss"], w16["loss"], abs(w16["loss"])),
            "grad_leaf_norm_rel_gap_max": max(gaps),
            "grad_leaf_norms": {names[i]: {
                "processes": got["grad_leaf_norms"][i],
                "bf16": w16["grad_leaf_norms"][i],
                "fp32": w32["grad_leaf_norms"][i] if fp32 else None,
                "gap": gaps[i]} for i in worst},
            "bf16_vs_fp32": {
                "loss_rel_gap": rel(w16["loss"], w32["loss"],
                                    abs(w32["loss"])),
                "grad_leaf_norm_rel_gap_max": max(own),
                "worst_leaf": names[max(range(len(own)),
                                        key=own.__getitem__)]}
            if fp32 else None}


def dist_family_runs(smoke=False, dev="cuda", seq=TRAIN_SEQ):
    """Phase 20 (b)'s runs: each DIST_FAMILIES model's yardsticks in this
    process (``dist_family_virtual``: the processes' bf16, and fp32 for
    DIST_FP32_ARCHS) and phase 20 (c)'s (``serve_yardsticks``), then one
    spawn of DIST_PROCS processes trains them all in turn and serves each
    layout, each process with expandable allocator segments. Returns
    ({arch: (yardsticks, each process's record)}, {layout: each process's
    record}, {layout: the yardstick's router choices}, the spawn's
    seconds, this process's and the card's memory before the spawn, the
    yardsticks' seconds)."""
    import torch.multiprocessing as mp
    want, seconds = {}, {}
    t = time.perf_counter()
    for arch in DIST_FAMILIES:
        cfg = dist_family_config(arch, smoke)
        want[arch] = {"bf16": dist_family_virtual(cfg, dev, seq),
                      "fp32": (dist_family_virtual(cfg, dev, seq, fp32=True)
                               if arch in DIST_FP32_ARCHS else None)}
    seconds["train"] = time.perf_counter() - t
    t = time.perf_counter()
    serve_want = serve_yardsticks(dev, smoke)
    seconds["serve"] = time.perf_counter() - t
    # The yardsticks' cached segments, which their live leaves pinned at
    # each run's own _free, go back to the card before the processes start.
    _free(dev)
    held = _device_memory(dev)
    print(json.dumps({"phase 20 (b) memory before the spawn": held}),
          file=sys.stderr, flush=True)
    d = tempfile.mkdtemp()
    torch.save(serve_want, os.path.join(d, "serve_want.pt"))
    serve_routes = {k: v["routes"] for k, v in serve_want.items()}
    del serve_want
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    # The four processes share the one card and reach their peaks together:
    # segments that grow in place keep what each reserves near its peak.
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        t = time.perf_counter()
        mp.start_processes(_dist_family_rank, args=(
            f"file://{os.path.join(d, 'init')}", d, smoke, dev, seq),
            nprocs=DIST_PROCS, join=True, start_method="spawn")
        wall = time.perf_counter() - t
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"),
                            weights_only=False) for r in range(DIST_PROCS)]
    finally:
        if conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
        shutil.rmtree(d, ignore_errors=True)
    return ({a: (want[a], [r[a] for r in ranks]) for a in DIST_FAMILIES},
            {n: [r["serve"][n] for r in ranks] for n in SERVE_LAYOUTS},
            serve_routes, wall, held, seconds)


def serve_config(arch, smoke=False):
    """Phase 20 (c)'s model of ``arch``: granite as phases 19 and 20 cut it
    (``dist_config``), the others as phase 20 (b) (``dist_family_config``)."""
    return dist_config(smoke) if arch == ARCH else \
        dist_family_config(arch, smoke)


def serve_inputs(cfg, rows, smoke, dev, seed=0):
    """A layout's prompt batch (tokens, a vlm's patches before them; an
    audio encoder's frames), its SERVE_NEW new tokens [rows, SERVE_NEW, 1]
    (None for an encoder) and the cache's ``max_len``."""
    prompt = SERVE_SMOKE_PROMPT if smoke else SERVE_PROMPTS.get(
        cfg.name, SERVE_PROMPT)
    rng = np.random.default_rng(seed)
    if cfg.family in ("vlm", "audio"):
        batch = av_batch(cfg, rows, prompt, dev, seed=seed)
    else:
        batch = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab, (rows, prompt)), device=dev)}
    if cfg.family == "audio":
        return batch, None, prompt
    new = torch.as_tensor(rng.integers(0, cfg.vocab, (rows, SERVE_NEW, 1)),
                          device=dev)
    return batch, new, prompt + SERVE_NEW + (
        cfg.n_patches if cfg.family == "vlm" else 0)


@contextlib.contextmanager
def routing_log(log: list):
    """Append each EP router call's top-k expert choices (on the device)
    to ``log`` while it runs: ``parallel.ep``'s ``router_topk``, logged."""
    from repro_torch.parallel import ep as ep_mod
    orig = ep_mod.router_topk

    def logged(router, x2d, mc):
        top_p, top_i = orig(router, x2d, mc)
        log.append(top_i.detach())
        return top_p, top_i
    ep_mod.router_topk = logged
    try:
        yield
    finally:
        ep_mod.router_topk = orig


def serve_layout(name, mesh, dev, smoke=False, want=None):
    """Phase 20 (c)'s layout ``name`` on ``mesh``: ``make_steps`` in its
    mode (granite with phase 20's EP, internvl2 with its FSDP,
    ``global_batch`` its rows) on fresh params (``_family_params``), a
    prefill then SERVE_NEW teacher-forced decode steps; a MoE's router
    calls logged each step (``routing_log``). Returns over virtual ranks
    (the yardstick) each step's logits on the host (fp32) and router
    choices; on a process mesh the rank's record: each step's largest gap
    from ``want``'s logits in each row beside ``want``'s largest logit,
    its router choices, whether its logits are finite, each step's ms and
    transfer seconds by kind, the prefill's and the last decode step's
    collectives and bytes, and the cache's bytes after the prefill and
    after the last step beside its ``cache_spec`` blocks'."""
    arch, mode, rows = SERVE_LAYOUTS[name]
    cfg = serve_config(arch, smoke)
    fns = steps_mod.make_steps(
        cfg, mesh, mode=mode, global_batch=rows,
        fsdp=DIST_FAMILIES.get(arch, (0, False))[1],
        ep=(EPConfig(mode="hyperparallel", capacity_factor=EP_CF)
            if cfg.family == "moe" else None))
    params = _family_params(cfg, dev)
    batch, new, max_len = serve_inputs(cfg, rows, smoke, dev)
    if mesh.local_rows:
        params = sharding.own_params(fns.rules, params, mesh)
        batch = sharding.batch_block(fns.rules, batch, mesh)
        if new is not None:
            new = sharding.batch_block(fns.rules, {"new": new}, mesh)["new"]
    stats = mesh.comm.stats
    rec = {"step_ms": [], "comm_seconds": [], "rows": rows, "mode": mode,
           "max_len": max_len}
    logits, routes = [], []

    def timed(fn):
        log = []
        _sync(dev)
        stats.reset()
        t = time.perf_counter()
        with (routing_log(log) if cfg.family == "moe"
              else contextlib.nullcontext()):
            out, cache = fn()
        _sync(dev)
        rec["step_ms"].append(1e3 * (time.perf_counter() - t))
        rec["comm_seconds"].append(dict(stats.seconds))
        logits.append(out.float().cpu())
        routes.append([t.cpu() for t in log])
        return cache

    cache = timed(lambda: fns.prefill_step(params, batch, max_len))
    rec["prefill_collectives"] = dict(stats.counts)
    rec["prefill_bytes"] = stats.bytes
    if cache is not None:
        rec["cache_bytes"] = [tree_bytes(cache)]
        for i in range(SERVE_NEW):
            cache = timed(lambda: fns.decode_step(params, new[:, i], cache))
        rec["decode_collectives"] = dict(stats.counts)
        rec["decode_bytes"] = stats.bytes
        rec["cache_bytes"].append(tree_bytes(cache))
        if mesh.local_rows:
            rec["cache_bytes_by_spec"] = tree_bytes(sharding.cache_blocks(
                fns.rules, rows, max_len, mesh, "meta"))
    del params, cache, fns
    if want is None:
        return {"logits": logits, "routes": routes}
    want = want["logits"]
    rec["gap"] = [[float((g[i] - w[i]).abs().max()) for i in range(rows)]
                  for g, w in zip(logits, want)]
    rec["scale"] = [float(w.abs().max()) for w in want]
    rec["routes"] = routes
    rec["finite"] = all(bool(torch.isfinite(g).all()) for g in logits) \
        and [g.shape for g in logits] == [w.shape for w in want]
    return rec


def decided_rows(name, ranks, want_routes) -> list:
    """[step][row]: whether each row's compared position (a prefill's
    last, a decode step's token) took the yardstick's experts at every
    layer. The processes' router calls of a layer are their ranks' (rank
    r's over its rows of its data group: a prefill's sequence chunk, a
    decode step's group rows); the yardstick's virtual ranks make the same
    calls in global rank order. ROADMAP §3's rule: a MoE's bf16 values are
    compared only where its expert choices agree."""
    rows = SERVE_LAYOUTS[name][2]
    world, m_n = math.prod(DIST_MESH), DIST_MESH[-1]
    b = rows // DIST_MESH[0]
    out = []
    for t in range(len(want_routes)):
        ok = [True] * rows
        for r, rec in enumerate(ranks):
            d, m = divmod(r, m_n)
            for layer, got in enumerate(rec["routes"][t]):
                want = want_routes[t][layer * world + r]
                agree = (got.sort(-1).values == want.sort(-1).values).all(
                    -1).reshape(b, -1)
                if agree.shape[1] > 1 and m != m_n - 1:
                    continue        # a prefill's last position: rank M-1's
                for i in range(b):
                    ok[d * b + i] &= bool(agree[i, -1])
        out.append(ok)
    return out


def serve_ranks(mesh, dev, smoke, want) -> dict:
    """Each layout of ``want`` (its yardstick by name, every SERVE_LAYOUTS
    layout in phase 20) on this rank (``serve_layout``), each with its
    launches (tensor cores beside them), its peak device bytes and its
    seconds."""
    out = {}
    for name in want:
        _free(dev)
        reset_launches()
        t = time.perf_counter()
        rec = serve_layout(name, mesh, dev, smoke, want[name])
        rec.update(seconds=time.perf_counter() - t,
                   launches=read_launches(),
                   launches_tc={"gmm_swiglu": swiglu_mod.launches_tc,
                                "gmm": gmm_mod.launches_tc},
                   peak_bytes=_peak(dev))
        out[name] = rec
    return out


def serve_yardsticks(dev, smoke) -> dict:
    """Each layout's logits and router choices in one process over
    DIST_MESH virtual ranks, in bf16 (``serve_layout``)."""
    out = {}
    for name in SERVE_LAYOUTS:
        out[name] = serve_layout(name, make_test_mesh(*DIST_MESH, device=dev),
                                 dev, smoke)
        _free(dev)
    return out


def _dist_serve_rank(rank, init, out_dir, name, smoke, dev):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=init,
                            world_size=DIST_PROCS, rank=rank)
    try:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // DIST_PROCS))
        rec = serve_ranks(dist_mesh(DIST_MESH), dev, smoke, {
            name: torch.load(os.path.join(out_dir, "want.pt"),
                             weights_only=False)})[name]
        torch.save(rec, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dist_serve_spawn(name, smoke=True, dev="cpu") -> dict:
    """Phase 20 (c)'s layout ``name`` alone in a spawn of DIST_PROCS
    processes of its own (phase 21 (a)'s check without phase 20's spawn, as
    the CPU tests run it): its row, gated (``dist_serve_check``)."""
    import torch.multiprocessing as mp
    d = tempfile.mkdtemp()
    try:
        want = serve_layout(name, make_test_mesh(*DIST_MESH, device=dev),
                            dev, smoke)
        torch.save(want, os.path.join(d, "want.pt"))
        mp.start_processes(_dist_serve_rank, args=(
            f"file://{os.path.join(d, 'init')}", d, name, smoke, dev),
            nprocs=DIST_PROCS, join=True, start_method="spawn")
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"),
                            weights_only=False) for r in range(DIST_PROCS)]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return dist_serve_check({name: ranks}, {name: want["routes"]}, dev)[name]


def serve_launches_per_process() -> dict:
    """A granite layout's GMM launches in one process: each forward (the
    prefill and SERVE_NEW decode steps) makes an FFN call at each of the
    ring's ep steps a layer, each one ``gmm_swiglu`` and one ``gmm``."""
    n = (1 + SERVE_NEW) * DIST_LAYERS * DIST_MESH[-1]
    return {"gmm_swiglu": n, "gmm": n}


def dist_serve_check(recs: dict, routes: dict, dev) -> dict:
    """Phase 20 (c)'s gates on every process's record of each layout
    (``recs``: name -> the ranks' records; ``routes``: name -> the
    yardstick's router choices): each prefill's and decode step's logits
    within LOGIT_TOL x max|logit| of the one-process bf16 yardstick, a
    MoE's in the rows whose experts agree (``decided_rows``), at least
    half of its rows and steps; finite logits; the cache's bytes those of
    its ``cache_spec`` blocks after the prefill and the last step; on the
    card, granite's ``gmm_swiglu``/``gmm`` launches their formula, all on
    the tensor cores, and none for the other families. Returns the
    rows."""
    rows, failed = {}, []
    for name, ranks in recs.items():
        arch = SERVE_LAYOUTS[name][0]
        r0 = ranks[0]
        decided = (decided_rows(name, ranks, routes[name]) if routes[name]
                   and routes[name][0] else
                   [[True] * r0["rows"] for _ in r0["scale"]])
        rel = max(g / max(s, 1e-30) for r in ranks
                  for gs, s, ok in zip(r["gap"], r["scale"], decided)
                  for g, k in zip(gs, ok) if k)
        n = sum(map(sum, decided))
        decode = r0["step_ms"][1:]
        row = {
            "mode": r0["mode"], "rows": r0["rows"], "max_len": r0["max_len"],
            "logit_rel_gap_max": rel,
            "logit_rel_gap_all_rows": max(
                g / max(s, 1e-30) for r in ranks
                for gs, s in zip(r["gap"], r["scale"]) for g in gs),
            "rows_compared": [n, r0["rows"] * len(decided)],
            "prefill_ms": r0["step_ms"][0],
            "decode_ms_median": (statistics.median(decode) if decode
                                 else None),
            "prefill_collectives": r0["prefill_collectives"],
            "prefill_bytes": r0["prefill_bytes"],
            "decode_collectives": r0.get("decode_collectives"),
            "decode_bytes": r0.get("decode_bytes"),
            "prefill_comm_s": r0["comm_seconds"][0],
            "comm_s_per_step": r0["comm_seconds"][1:],
            "peak_bytes_per_process": [r["peak_bytes"] for r in ranks],
            "cache_bytes_per_process": [r.get("cache_bytes")
                                        for r in ranks],
            "cache_bytes_by_spec": r0.get("cache_bytes_by_spec"),
            "launches_per_process": [r["launches"] for r in ranks],
            "seconds": r0["seconds"]}
        why = []
        if rel > LOGIT_TOL:
            why.append("logits beyond the yardstick")
        if 2 * n < r0["rows"] * len(decided):
            why.append("fewer than half the rows took the same experts")
        if not all(r["finite"] for r in ranks):
            why.append("non-finite logits")
        if "cache_bytes" in r0 and any(
                r["cache_bytes"] != [r0["cache_bytes_by_spec"]] * 2
                for r in ranks):
            why.append("cache not its cache_spec blocks")
        if torch.device(dev).type == "cuda":
            want = (serve_launches_per_process() if arch == ARCH else {})
            for r in ranks:
                got = {k: v for k, v in r["launches"].items() if v}
                tc = {k: v for k, v in r["launches_tc"].items() if v}
                if got != want or tc != want:
                    why.append(f"launches {got} (tensor cores {tc}) != "
                               f"{want}")
                    break
        if why:
            failed.append((name, why, row))
        rows[name] = row
    if failed:
        raise AssertionError(f"phase 20 (c): {failed}")
    return rows


def _device_memory(dev):
    """This process's allocated and reserved bytes and the card's free and
    total bytes (``torch.cuda.mem_get_info``), or None on the CPU."""
    if torch.device(dev).type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info()
    storages = {}
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor) and o.is_cuda:
            st = o.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
    return {"allocated_bytes": torch.cuda.memory_allocated(),
            "reserved_bytes": torch.cuda.memory_reserved(),
            "live_tensor_storages": len(storages),
            "live_tensor_bytes": sum(storages.values()),
            "device_free_bytes": free, "device_total_bytes": total}


def run_dist_families(smoke=False, dev="cuda", seq=TRAIN_SEQ):
    """Phase 20 (b): ``dist_family_runs`` and its gates: step 0's loss
    within LOSS_TOL and each reduced grad leaf's norm within GNORM_TOL of
    the one-process bf16 run's (``dist_family_gaps``); finite losses; each
    process's params and optimizer state the bytes of its spec blocks; no
    kernel launch (cuBLAS and plain ops). Returns the runs' rows and their
    launches (every process's, summed)."""
    runs, serve, serve_routes, wall, held, yard_s = dist_family_runs(
        smoke, dev, seq)
    rows, total, failed = {}, {k: 0 for k in COUNTERS}, []
    for arch, (want, recs) in runs.items():
        cfg = dist_family_config(arch, smoke)
        fsdp = DIST_FAMILIES[arch][1]
        log = recs[0]["log"]
        gaps = dist_family_gaps(cfg, log[0], want)
        n_params, param_bytes = dist_expected_params(cfg, "tp_sp", fsdp)
        opt_bytes = dist_expected_opt_bytes(cfg, "tp_sp", fsdp)
        launches = [r["launches"] for r in recs]
        step_ms = [m["step_ms"] for m in log]
        row = {
            "n_layers": cfg.n_layers, "fsdp": fsdp,
            "losses": [m["loss"] for m in log],
            "grad_norms": [m["grad_norm"] for m in log],
            "step_ms": step_ms,
            "step_ms_after_warmup": step_ms[1:], **gaps,
            "collectives_per_rank_per_step": log[-1]["collectives"],
            "comm_bytes_per_rank_per_step": log[-1]["comm_bytes"],
            "comm_s_per_step": [m["comm_seconds"] for m in log[1:]],
            "peak_bytes_per_process": [r["peak_bytes"] for r in recs],
            "peak_reserved_bytes_per_process": [r["peak_reserved_bytes"]
                                                for r in recs],
            "params_per_process_by_spec": n_params,
            "param_bytes_per_process": [r["param_bytes"] for r in recs],
            "param_bytes_by_spec": param_bytes,
            "opt_state_bytes_per_process": [r["opt_state_bytes"]
                                            for r in recs],
            "opt_state_bytes_by_spec": opt_bytes,
            "launches_per_process": launches}
        why = []
        if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                   for r in recs for m in r["log"]):
            why.append("non-finite metrics")
        if gaps["loss_rel_gap"] > LOSS_TOL or \
                gaps["grad_leaf_norm_rel_gap_max"] > GNORM_TOL:
            why.append("beyond the yardstick")
        if any(b != opt_bytes for b in row["opt_state_bytes_per_process"]) \
                or any(b != param_bytes
                       for b in row["param_bytes_per_process"]):
            why.append("params or optimizer state not the spec's blocks")
        if any(any(r.values()) for r in launches):
            why.append("kernel launches")
        if why:
            failed.append((arch, why, row))
        for k in COUNTERS:
            total[k] += sum(r.get(k, 0) for r in launches)
        rows[arch] = row
    if failed:
        raise AssertionError(f"phase 20 (b): {failed}")
    serving = dist_serve_check(serve, serve_routes, dev)
    for recs in serve.values():
        for k in COUNTERS:
            total[k] += sum(r["launches"].get(k, 0) for r in recs)
    return {"runs": rows, "steps": DIST_FAMILY_STEPS, "spawn_wall_s": wall,
            "serving": serving, "serve_new": SERVE_NEW,
            "logit_tol": LOGIT_TOL, "yardstick_seconds": yard_s,
            "parent_memory_before_spawn": held}, total


def dist_count_case(pcfg, fsdp, seq=TRAIN_SEQ):
    """Phase 21 (a): phase 20's tp_sp step of ``pcfg`` (``fsdp``) counted
    on rank 0 of a counting mesh of DIST_MESH, with the launcher's EP
    (``launch.train``): the ``Roofline`` of the count."""
    sp = ShapeSpec("train_4k", seq, DIST_BATCH, "train")
    return dryrun_mod.count_cell(
        pcfg, sp, counting_mesh(DIST_MESH), mode="tp_sp", fsdp=fsdp,
        ep=EPConfig(mode="hyperparallel", capacity_factor=EP_CF))[0]


def serve_count_case(smoke=False):
    """Phase 21 (a): phase 20 (c)'s granite tp_sp prefill and one decode
    step counted on rank 0 of a counting mesh of DIST_MESH: {"prefill":
    (collectives, bytes), "decode": (...)} of the forward."""
    name = f"{ARCH}/tp_sp"
    _, mode, rows = SERVE_LAYOUTS[name]
    cfg = serve_config(ARCH, smoke)
    mesh = counting_mesh(DIST_MESH)
    fns = steps_mod.make_steps(
        cfg, mesh, mode=mode, global_batch=rows,
        ep=EPConfig(mode="hyperparallel", capacity_factor=EP_CF))
    params = sharding.own_params(fns.rules, M.init_params(
        cfg, device="meta"), mesh)
    batch, new, max_len = serve_inputs(cfg, rows, smoke, "meta")
    batch = sharding.batch_block(fns.rules, batch, mesh)
    new = sharding.batch_block(fns.rules, {"new": new}, mesh)["new"]
    stats, out = mesh.comm.stats, {}
    stats.reset()
    _, cache = fns.prefill_step(params, batch, max_len)
    out["prefill"] = (dict(stats.counts), stats.bytes)
    stats.reset()
    fns.decode_step(params, new[:, 0], cache)
    out["decode"] = (dict(stats.counts), stats.bytes)
    return out


def prod_check(results) -> tuple:
    """Phase 21 (b)'s rows of ``dryrun.count_job``'s ``results``, and the
    failures and the rows below the FLOPs floor."""
    rows, failures, low = [], [], []
    for row, fail in results:
        if fail is not None:
            failures.append(fail)
            continue
        rows.append(dict({k: row[k] for k in (
            "arch", "shape", "mesh", "mode", "chips", "flops_per_dev",
            "flops_floor",
            "bytes_per_dev", "t_compute_s", "t_memory_s", "t_collective_s",
            "bottleneck", "hbm_args_gb", "hbm_temp_gb", "collectives",
            "collective_bytes_per_dev", "count_s")},
            device_gb=row["hbm_args_gb"] + row["hbm_temp_gb"]))
        if row["flops_per_dev"] * row["chips"] < row["flops_floor"]:
            low.append((row["arch"], row["mesh"], row["mode"]))
    return rows, failures, low


class BackgroundCounts:
    """``dryrun.count_job`` cells of named groups (``{name: cells}``) in
    ``workers`` spawned processes, started on a thread of their own when
    made, so that they run while the card works on the phases in between;
    ``result(name)`` waits for them."""

    def __init__(self, groups: dict, workers=DRYRUN_WORKERS):
        self.groups = {k: list(v) for k, v in groups.items()}
        self.workers = workers
        self._pool = ThreadPoolExecutor(1)
        self.t0 = time.perf_counter()
        self._fut = self._pool.submit(self._count)

    def _count(self):
        todo = [c for cells in self.groups.values() for c in cells]
        results = iter(dryrun_mod.count_all(todo, self.workers,
                                            dryrun_mod.count_job))
        out = {k: [next(results) for _ in cells]
               for k, cells in self.groups.items()}
        return out, time.perf_counter() - self.t0

    def result(self, name):
        """(the results of group ``name``, the pool's wall seconds, the
        seconds waited here)."""
        t = time.perf_counter()
        results, wall = self._fut.result()
        self._pool.shutdown()
        return results[name], wall, time.perf_counter() - t


def prod_cells(smoke=False, cells=None, shape="train_4k",
               serve_cells=None, serve_mesh="16x16") -> list:
    """Phase 21 (b)'s ``count_job`` cells: ``cells`` ((arch, mode, mesh);
    default PROD_CELLS, smoke configs with ``smoke``) of ``shape``, then
    ``serve_cells`` ((arch, shape); default PROD_SERVE_CELLS) in tp_sp on
    ``serve_mesh``."""
    base = get_smoke_config if smoke else get_config
    serve = PROD_SERVE_CELLS if serve_cells is None else serve_cells
    return ([(base(a), shape, mesh, mode, "hyperparallel")
             for a, mode, mesh in (cells or PROD_CELLS)]
            + [(base(a), s, serve_mesh, "tp_sp", "hyperparallel")
               for a, s in serve])


def run_prod_dryrun(tp_runs, counts: BackgroundCounts, *, smoke=False,
                    seq=TRAIN_SEQ, served=None):
    """Phase 21: (a) each of phase 20's tp_sp runs (``tp_runs``, its
    ``runs`` by name) counted and held to its recorded collectives and
    bytes, and phase 20 (c)'s granite tp_sp prefill and decode step
    (``served``: its row of phase 20's ``serving``) the same way, (b)
    ``counts``' group ``prod`` (``prod_cells``) gated. Returns the
    phase's line; raises unless every gate holds."""
    t_phase = time.perf_counter()
    pcfg = dist_config(smoke)
    counted = {}
    if served is not None:
        got = serve_count_case(smoke)
        counted["serve"] = {
            step: {"forward_collectives": got[step][0],
                   "forward_bytes": got[step][1],
                   "processes_collectives": served[f"{step}_collectives"],
                   "processes_bytes": served[f"{step}_bytes"]}
            for step in ("prefill", "decode")}
        if any(got[step] != (served[f"{step}_collectives"],
                             served[f"{step}_bytes"])
               for step in ("prefill", "decode")):
            raise AssertionError(f"phase 21 (a) serving: the counted steps "
                                 f"are not the processes' ones: "
                                 f"{counted['serve']}")
    for name, fsdp in DIST_TP_RUNS.items():
        run = tp_runs[name]
        rf = dist_count_case(pcfg, fsdp, seq)
        fwd = rf.coll_forward
        counted[name] = {
            "fsdp": fsdp, "forward_collectives": fwd["counts"],
            "forward_bytes": fwd["bytes"],
            "processes_collectives": run["collectives_per_rank_per_step"],
            "processes_bytes": run["comm_bytes_per_rank_per_step"],
            "all_transfers": rf.coll_counts,
            "all_transfer_bytes": rf.collective_bytes,
            "flops_per_dev": rf.flops_per_device,
            "hbm_args_gb": rf.arg_bytes / 2**30,
            "hbm_temp_gb": rf.temp_bytes / 2**30}
        if (fwd["counts"] != run["collectives_per_rank_per_step"]
                or fwd["bytes"] != run["comm_bytes_per_rank_per_step"]):
            raise AssertionError(f"phase 21 (a) {name}: the counted step "
                                 f"is not the processes' one: "
                                 f"{counted[name]}")
    results, wall, waited = counts.result("prod")
    rows, failures, low = prod_check(results)
    out = {"phase": "dryrun_meshes", "counted_dist_tp": counted,
           "rows": rows, "failures": failures, "flops_below_floor": low,
           "workers": counts.workers, "wall_s": wall, "waited_s": waited,
           "cell_count_s_sum": sum(r["count_s"] for r in rows),
           "seconds": time.perf_counter() - t_phase}
    if failures or low:
        raise AssertionError(f"phase 21 (b) failed its gates: "
                             f"{json.dumps({'failures': failures, 'low': low})}")
    return out


def swiglu_add_entry(name, spec, checks, bench_out, by_path):
    """The ``kernels`` line's entry of a swiglu_add mode: timed at the
    paper's largest size in bf16 (M = 32768), with every size beside it."""
    mode = name.removeprefix("swiglu_add_")
    mine = [r for r in bench_out["kernels"] if r["mode"] == mode]
    r = next(r for r in mine if r["M"] == 32768 and r["dtype"] == "bfloat16")
    worst = max([x["max_abs_err"] for x in checks if x["kernel"] == name]
                + [x["max_abs_err"] for x in mine])
    return {"name": name, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": worst, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,
            "shape": {"M": r["M"], "F": r["F"], "dtype": r["dtype"]},
            "paper_sizes": [{k: x[k] for k in ("M", "dtype", "ms",
                                                "plain_ms", "bound_ms")}
                            for x in mine]}


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    t_script = time.perf_counter()
    # Phase 15 runs under use_deterministic_algorithms, which accepts cuBLAS
    # only with this variable set. cuBLAS reads it once, when the first
    # handle is made, so it is set before any phase; ":4096:8" (32 MiB) is
    # the workspace PyTorch chooses on sm_90 without it.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t = time.perf_counter()
    libs = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "libraries": {k: os.path.basename(v) for k, v in libs.items()},
          "ptxas": {src: ptxas_report(
              open(f"{libs[src]}.log", encoding="utf-8").read())
              for src in ("gmm.cu", "gmm_swiglu.cu", "gmm_swiglu_bwd.cu")}})

    swa_checks, bench_out, swa_launches = run_swiglu_add()
    emit({"phase": "swiglu_add_sim",
          "note": "a prediction of the Ascend A3 model, not a measurement",
          "rows": bench_out["sim"]})
    emit({"phase": "swiglu_add", "checks": swa_checks,
          "bench_rows": bench_out["kernels"], "calls": bench_out["calls"],
          "launches": swa_launches})

    cfg = get_config(ARCH)
    rows, caps = check_kernels(cfg)
    emit({"phase": "kernel_checks", "capacities": caps, "rows": rows})

    slice_out, serve_launches = run_slice(cfg)
    emit(slice_out)
    emit(run_train_parity(cfg))
    train_out, train_launches = run_train(cfg, rows)
    emit(train_out)
    # Phase 17 (d)'s and phase 21 (b)'s counts are host work alone: they
    # run in DRYRUN_WORKERS processes while the card works on phases 7-16.
    counts = BackgroundCounts({
        "audio_vlm": dryrun_grid() + list(run_cells().values()),
        "prod": prod_cells()})

    tile_rows, body_launches = run_dropless_tiles(cfg)
    bits_rows = row_count_bits(cfg)
    emit({"phase": "dropless_tiles",
          "fp32_tiled_min_rows": gmm_mod.FP32_TILED_MIN_ROWS,
          "fp32_tiled_launches": body_launches["tiled"],
          "fp32_narrow_launches": body_launches["narrow"],
          "rows": tile_rows, "row_count_bits": bits_rows})
    rows += tile_rows
    emit(run_dropless_fragment())
    dropless_out, dropless_launches = run_dropless_train(cfg)
    emit(dropless_out)
    path_launches = {}
    for path, run in (("fused_dropless", run_fused_dropless),
                      ("pp_fused", partial(run_pp_fused, cfg)),
                      ("elastic", partial(run_elastic, cfg))):
        reset_launches()
        emit(run())
        path_launches[path] = read_launches()
        if path_launches[path]["gmm"] == 0 or any(
                v for k, v in path_launches[path].items() if k != "gmm"):
            raise AssertionError(f"{path} launches {path_launches[path]}: "
                                 f"gmm only, at least once")

    online_out, online_launches = run_serve_online(cfg, slice_out)
    emit(online_out)
    path_launches["serve_online"] = online_launches
    ep_out, ep_launches = run_ep(cfg)
    emit(ep_out)
    path_launches.update(ep_launches)
    ft_out, ft_launches = run_ft(cfg)
    emit(ft_out)
    path_launches.update(ft_launches)
    families_out, families_launches = run_families()
    emit(families_out)
    path_launches.update(families_launches)
    av_out, av_launches = run_audio_vlm(counts)
    emit(av_out)
    path_launches.update(av_launches)
    tools_out, tools_launches = run_tools()
    emit(tools_out)
    path_launches.update(tools_launches)
    _free()
    dist_out, dist_launches = run_dist_train()
    emit(dist_out)
    path_launches["dist_train"] = dist_launches
    _free()
    dropless_dist_out, path_launches["dist_dropless"] = run_dist_dropless()
    emit(dropless_dist_out)
    _free()
    tp_out, tp_launches = run_dist_tp()
    tp_out["script_seconds"] = time.perf_counter() - t_script
    emit(tp_out)
    path_launches["dist_tp"] = tp_launches
    prod_out = run_prod_dryrun(
        tp_out["runs"], counts,
        served=tp_out["families"]["serving"][f"{ARCH}/tp_sp"])
    prod_out["script_seconds"] = time.perf_counter() - t_script
    emit(prod_out)

    kernels = []
    timing = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for name, spec in KERNELS.items():
        by_path = {"serving": serve_launches[name],
                   "training": train_launches[name],
                   "swiglu_add_bench": swa_launches[name],
                   "dropless": dropless_launches[name],
                   **{p: n[name] for p, n in path_launches.items()}}
        if name.startswith("swiglu_add"):
            kernels.append(swiglu_add_entry(name, spec, swa_checks,
                                            bench_out, by_path))
            continue
        # The headline shape: for the forward kernels a decode step of the
        # 8-slot batch, the call the serving path makes most often; for the
        # backward the training shape, its only one.
        tag = "train" if name == "gmm_swiglu_bwd" else "decode8"
        r = next(r for r in rows if r["kernel"] == name
                 and r.get("shape") == tag and r["dtype"] == "bfloat16")
        t = next(r for r in rows if r["kernel"] == name
                 and r.get("shape") == "train")
        worst = max(x["max_abs_err"] for x in rows if x["kernel"] == name)
        kernels.append({
            "name": name, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": worst, **{k: r[k] for k in timing},
            "shape": {k: r[k] for k in ("E", "C", "K", "N", "dtype")},
            "train_shape": {k: t[k] for k in (
                "C", "K", "N", *timing, "eager_ms", "host_us", "gemm_only_ms",
                "fp32_out_ms", "body") if k in t}})
        for key, tags in (("ep_shapes", ("ep_", "paper_")),
                          ("dbrx_shapes", ("dbrx_",))):
            kernels[-1][key] = [
                {k: x[k] for k in ("shape", "E", "C", "K", "N", *timing,
                                   "gemm_only_ms", "fp32_out_ms")
                 if k in x}
                for x in rows if x["kernel"] == name
                and x.get("shape", "").startswith(tags)]
        if name == "gmm":          # the dropless tiles' calls, fp32, E = 1
            dist_fp32 = {body: sum(
                s[i] for row in dropless_dist_out["modes"].values()
                for st in row["gmm_per_process_per_step"] for s in st)
                for i, body in ((1, "tiled"), (2, "narrow"), (3, "small"))}
            kernels[-1]["fp32_tiled_body"] = {
                "source": "src/repro_torch/kernels/csrc/gmm_fp32.cuh",
                "launches_by_path": {
                    "dropless": dropless_out["gmm_fp32_tiled_launches"],
                    "serve_online":
                        online_out["gmm_fp32_launches"]["tiled"],
                    "dist_dropless": dist_fp32["tiled"]}}
            kernels[-1]["fp32_narrow_body"] = {
                "source": "src/repro_torch/kernels/csrc/gmm_fp32_narrow.cuh",
                "launches_by_path": {
                    "dropless": dropless_out["gmm_fp32_narrow_launches"],
                    "serve_online":
                        online_out["gmm_fp32_launches"]["narrow"],
                    "dist_dropless": dist_fp32["narrow"]},
                "decode_tiles": [dict(x, tile=r["tile"], K=r["K"], N=r["N"])
                                 for r in bits_rows for x in r["timed"]]}
            kernels[-1]["fp32_small_body"] = {
                "source": "src/repro_torch/kernels/csrc/gmm_fp32_small.cuh",
                "launches_by_path": {
                    "serve_online":
                        online_out["gmm_fp32_launches"]["small"],
                    "dist_dropless": dist_fp32["small"]}}
            kernels[-1]["dropless_tiles"] = [
                {k: x[k] for k in ("tile", "C", "K", "N", "body", *timing)}
                for x in tile_rows if "ms" in x]
    if not all(math.isfinite(k["ms"]) for k in kernels):
        raise AssertionError(f"non-finite kernel time: {kernels}")
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
