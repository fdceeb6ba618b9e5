#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. card: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and
   power limit;
2. build: the three CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` (one process per source, started together), with ``-Xptxas -v``;
   then the bf16 kernels' and the scan's tiles, resident blocks per SM and
   grids at the shapes they are timed at;
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes of the UViT-H, Hunyuan-DiT-3B and SDv2 UNet train steps
   (flash attention at the UNet's six: self and cross at head dim 112 and
   224, B=16; bf16 on the tensor-core route, the head padded to 128 and
   256 in shared memory, fp32 on the SIMT route) and of the plan phase
   (batch 8: flash self and cross, the skip matmul at M=2064 and 8192;
   rows under path ``plan``; UViT-H's are also the supervisor's
   generation 1, one replica, rows ``supervisor uvit-h gen 1``) and of the
   ``hybrid`` phase (a data replica's microbatch of UViT-H, batch 4: flash
   at B=4, the skip matmul at M=1032, whose last row tile holds 8 rows;
   also the supervisor's generation 0, rows ``supervisor uvit-h gen 0``)
   and of the small models the ``skipvit`` and ``supervisor`` phases
   train (``uvit-nano``: flash at 6 tokens, 2 heads of 16, the skip
   matmul at M=12 D=N=32, microbatch 2, and a data replica's half of it,
   ``uvit-nano dp=2``; ``skipvit``: flash at 18 tokens, 4 heads of 16;
   microbatch 2) and of the ``lm`` phase (flash causal GQA at sequence
   4096: smollm-360m's microbatch, B=2 Hq=15 Hkv=5 D=64, and
   qwen3-moe-30b-a3b's batch, B=2 Hq=32 Hkv=4 D=128; and its smoke
   keys' batch 4 of 32 tokens, heads of 16, causal: GQA 4:2, with a window
   of 8, MQA 4:1, and S=40 with a vision prefix; rows ``lm ...``, SDPA
   with ``enable_gqa`` the library call) and of the ``recurrent`` phase
   (whisper-base, batch 8, 8 heads of 64: the encoder's self-attention
   over 4096 frames, the decoder's causal self-attention over 447 tokens
   and its cross-attention over the 4096 frames; its smoke key's three
   at batch 4, heads of 8; rows ``whisper-base ...`` and ``recurrent
   smoke ...``) and of the ``serve`` phase (over KV caches, the kernel
   reading the whole cache in place with ``q_offset`` and
   ``kv_valid_len``: smollm-360m's prefill, batch 16, 2048 prompt rows
   in a cache of 2112, and a decode step at 2100; whisper-base's decoder
   self-attention at a decode step in a cache of 128 and its
   cross-attention of one token over 4096 frames; zamba2-2.7b's shared
   attention at a decode step, 32 heads of 80, in a cache of 288; rows
   ``serve ...``; SDPA with the boolean mask the library call) and at
   head dim 80 (zamba2-2.7b's shared attention at its training shape,
   h2o-danube-1.8b's full shape with its window; SDPA with the boolean
   mask wherever a window is set) and of the ``registry`` phase (flash
   causal GQA at sequence 4096 at a microbatch of 1: smollm-360m's 15:5 at
   head dim 64, internlm2-20b's 48:8 at 128; rows ``registry ...``) and
   of the ``sharded ranks`` phase (a data replica's rows: the UNet's six
   at B=8, whisper-base's encoder, decoder, cross and a serve step's two
   at B=4; rows ``sharded ...``; its TP runs' rank heads, rows ``tp ...``:
   h2o-danube-1.8b's 16 q over 4 kv heads at D=80 with its window (its
   prefill of 32768 tokens held on 512 query rows: ``check_flash_long``),
   smollm-360m's runs of 6:2 and 2:1 heads at D=64) (the
   gated linear scan at zamba2-2.7b's carry across
   chunks on the ``recurrent`` path, R=2 T=32 C=327,680, at its Mamba2
   width over 4k steps and at R=32 over 2k steps, forward and backward
   kernels, with mixed dtypes of a and x, and with decays near 1, whose
   carry spans many chunks; see ``check_scan``), forward and
   gradients (fp32 with TF32 off at rtol =
   atol = 1e-4; bf16 at rtol = atol = 2e-2, bf16 rounding in another
   summation order; only the skip matmul's weight gradient, a sum over all
   M rows, takes atol = rtol x max|value|; a bf16 flash output, small
   where a row averages many keys, is also held to the fp32 plain version
   of the same inputs at a relative Frobenius error of 1e-2), then timed beside its bound,
   the plain version and a yardstick PyTorch call the port never makes:
   ``ms``, ``plain_ms`` and ``library_ms`` with CUDA events around 20
   calls as issued from Python (host cost included, as a train step pays
   it), and ``device_ms``, ``plain_device_ms`` and ``library_device_ms``
   as the replay of the same 20 calls captured in one CUDA graph (the
   device's time alone); each flash row names its route (``flash_route``);
3b. kernel_check (``kernel_check_phase``): the launch predicates of
   ``repro_torch.analysis.kernel_check`` against the kernels: every shape
   of a grid (the table's paths and each side of each rule, both dtypes)
   that a predicate accepts launches and equals its plain version, every
   one it refuses raises before a launch; each route's predicted tiles
   and shared memory equal the kernel's own report, and the budget the
   card's opt-in shared memory a block;
4. pipeline parity: the port's wave executor at ``uvit-pp`` size (D=4, M=8),
   at ``hunyuan-pp`` size (D=2 and D=4, M=4) and at the supervisor drills'
   ``uvit-nano`` pipeline (D=2, M=4, global batch 8), each config the trainer's
   own, fp32, fp32 wire, kernels on, on the card against the same step on
   the CPU (plain versions): loss and grads at rtol 1e-3; then in bf16 through the kernels' bf16 routes (a
   Hunyuan-DiT config with 2 heads of 128, 4 blocks, 77 text tokens, D=2,
   M=4) against the same params in fp32 on the CPU: loss at rtol 2e-2,
   each gradient at ||err|| / ||g|| <= 5e-2; then the linear (skip-free)
   executors, table and closed form, on a graph of UViT encoder blocks
   (D=2, M=4, uneven cuts, fp32, fp32 wire) against the CPU: loss and
   grads at rtol 1e-3, flash launched; then a narrow SDv2 UNet
   whose single heads are 112 and 224 wide (``UNET_PARITY``), flash on,
   on the card against the CPU: fp32 loss and grads at rtol 1e-4, bf16
   loss at rtol 2e-2, two flash launches per attention block;
5. plan (``plan_phase``): every one of the 32 blocks of UViT-H and of
   Hunyuan-DiT-3B (full width, bf16, seed 0) timed forward by
   ``core.profiler.measure_block_times`` at batch 8 (one microbatch of
   global batch 16 at the tuner's M=2), every block through flash
   attention and every decoder block through the skip matmul (launches
   counted exactly); the measured graphs (``fwd_times``) beside the
   roofline ones: block ms, the cuts at D=4 V=1 and ``tune``'s top five
   choices and drops at N=2 and 4 on both; ``auto_pipeline(graph, fns, 4)``
   on the measured graphs must plan the tuner's own choice (P=2 with two
   data replicas, G=2) and certify it; then UViT-H on the tuner's
   own N=2 plan (``auto_pipeline(graph, fns, 2)``, certified), 4 steps
   through ``repro_torch.launch.train.run(args, compiled=plan)`` at global
   batch 16, the plan's M, bf16 wire, both pipeline
   devices on the one card: losses finite, both kernels launched, the
   peak device memory beside twice the busiest device's Eq. 14
   prediction;
6. train UViT-H: ``repro_torch.launch.train`` with ``--arch uvit-h
   --pipeline --devices 4 --microbatches 8 --global-batch 16 --steps 4``
   (UViT-2.7B at full width and depth, bf16, bf16 wire) with the launch
   counts reset just before and read just after: every loss finite, both
   kernels of the path launched; recorded for phase 12: step 0's gradient
   fingerprints before its update and the ``HOP_BYTES`` a step; then
   every reference to the trainer is dropped and the card's memory
   released;
6b. baseline (``baseline_phase``), after checking that less than 1 GB is
   still allocated: UViT-H at full width and depth (bf16, random weights
   from seed 0, the trainer's plan D=4 M=8, global batch 16) through the
   table wave executor (fp32 wire), the same plan's closed-form wave and
   the paper's skip-carry baseline, one at a time from the same params
   and microbatches, the card released between them; each one warm-up
   and 3 timed forward+backward steps: step ms (median, spread), peak
   memory, flash and skip launches a step, the bytes handed to the ring
   (dense and live, forward only), beside ``partition_comm_volume`` of
   the PULSE and the sequential partitions; closed form vs table at loss
   rtol 1e-3 and ||err||/||g|| <= 1e-2 per gradient, skip-carry vs table
   at 2e-2 and 5e-2;
7. checkpoint UViT-H (``checkpoint_phase``), full width at 8 of its 32
   blocks (``CKPT_LAYERS``), the same argv plus a ``--ckpt-dir`` under
   ``build/``: R trains steps 0-3 without a save, A trains steps 0-1 and
   saves step 2, B resumes at the same plan (restored state bitwise A's,
   steps 2-3 within 2e-2 of R's losses) and saves step 4 beside step 2
   (GC hashes neither; step 4 is then removed), C resumes
   elastically at D=2 (logical params bitwise A's, one finite step); the
   launch counts are reset before B and before C and read after each;
   prints bytes, the save's blocking and total seconds, write and verify
   rates, each restore's seconds and peak device memory;
8. train Hunyuan-DiT-3B: the same as 6 with ``--arch hunyuan-dit``
   (d=2048, 32 blocks, 1024 tokens, cross-attention over 77 text tokens,
   full width and depth, bf16), after checking that less than 1 GB is
   still allocated;
9. train the SDv2 UNet: ``--arch sdv2-unet-full`` without ``--pipeline``
   (1.84e9 params at full width, bf16, global batch 16, 4 steps, random
   weights from seed 0, nothing cut): every loss finite, exactly 32 flash
   launches a step (every attention call through the kernel), peak
   device memory printed;
10. skipvit (``skipvit_train``, ``skipvit_wave_asym``): ``repro_torch.launch.train.run`` with
    ``--arch skipvit --pipeline --devices 2`` (M=4, global batch 8, 3
    steps, fp32 wire) on the card, launch counts reset just before, against
    the same argv, params and draws on the CPU: losses at rtol 1e-3; then
    the SkipViT wave step on the JAX package's ``wave-asym`` config with its
    block costs (the fold's turnaround cut off-centre), card against CPU,
    fp32, loss and grads at rtol 1e-3; flash attention must launch in both,
    the skip matmul never (SkipViT's skip is additive);
16. lm (``lm_smollm``, ``lm_qwen3``, ``lm_smoke``), after phase 10 and
    after checking that less than 1 GB is still allocated: (a)
    smollm-360m at full width, 8 of its 32 layers (``LM_LAYERS``: d=960,
    15 heads over 5 KV heads of 64, vocab 49152 tied; bf16, random
    weights from seed 0) at sequence 4096, global batch 16, through
    ``auto_pipeline(lm_pipeline_graph(CFG), lm_model_fns(CFG), 4)`` at
    D=4, M=8 on two plans, the folded wave (``force_wave=True``: the tied
    embedding and readout on device 0) and the linear table plan, two
    AdamW steps each from the same weights: step seconds, peak memory,
    every loss finite, every step's loss within 1e-4 relative of the
    reference's (the non-pipeline ``lm_loss`` on the same weights and
    batch, a microbatch at a time, and the same AdamW steps) and of the
    other plan's, the first gradient norm within 1e-2 of the reference's,
    the flash launches of every step equal to the step tables' count
    (each stage task's blocks, twice: forward and the remat recompute);
    (b)
    qwen3-moe-30b-a3b at full width with its depth cut to 2 of 48 layers
    to fit one card (1,868,573,184 params; qk-norm, GQA 32:4 at head dim
    128, 128-expert top-8 scatter dispatch): one non-pipeline
    value-and-grad of ``lm_loss`` at sequence 4096, batch 2, and one AdamW
    step: finite losses and gradients, flash twice a layer (the config's
    remat); (c) each of the seven LM smoke keys through
    ``repro_torch.launch.train`` for one step (global batch 4) on the
    card and on the CPU from the same params and batch: losses at rtol
    1e-5 (fp32), flash once a layer on the card (the SIMT route; danube
    with its window), none for deepseek's MLA; the kernel phase holds
    flash at these shapes (``lm smoke`` rows: GQA 4:2, its window of 8,
    MQA 4:1, S=40 with internvl2's prefix, which the trainer's batch
    leaves out, as the JAX trainer's does);
17. recurrent (``recurrent_whisper``, ``recurrent_xlstm``,
    ``mamba2_block_parity``, ``recurrent_zamba2``, ``lm_smoke`` on the
    three keys), after phase 16, each run after checking that less than
    1 GB is still allocated; bf16, random weights from seed 0, 3 AdamW
    steps each, step seconds and peak memory printed beside the card's
    name and power limit: (a) whisper-base at full width and depth (6+6
    layers, d=512, 8 heads of 64; 70,658,560 params), frames 4096 and
    tokens 448, batch 8, flash on every attention: finite losses, flash
    exactly 18 launches a step (encoder self, decoder causal self, cross;
    forward only), the first loss within 1e-2 relative of the same loss
    with the dense attention; (b) xlstm-125m at full width, its depth
    cut to 6 of 12 blocks (one sLSTM), S=4096,
    batch 2: finite losses, no kernel; (c) one value-and-grad of a full-width Mamba2 block of
    zamba2-2.7b (fp32, S=4096, batch 2) through the scan route
    (``_ssd_chunked``) and the plain chunk loop, the output and every
    gradient leaf at rtol 1e-4; (d) zamba2-2.7b at full width, its depth
    cut to 12 of 54 Mamba2 blocks (both shared blocks run, after blocks 5
    and 11; 770,243,904 params), S=4096, batch 2: finite losses, the scan
    exactly 24 launches a step (forward and backward of each block),
    flash 2 (the shared attention, 32 heads of 80, once a site); (e) the
    three smoke keys one trainer step each, card vs CPU at rtol 1e-5
    (whisper's frames handed to both), flash 6 a step for whisper, the
    scan 12 and flash 2 for zamba2;
18. serve (``serve_smollm``, ``serve_whisper``, ``serve_recurrent``,
    ``serve_smoke``), after phase 17, each model after checking that
    less than 1 GB is still allocated; bf16, random weights from seed 0,
    full width (depth: smollm and whisper whole; xLSTM and Zamba2 at the
    recurrent phase's 6 and 12 blocks), launch
    counts reset just before the serving
    loop and read just after: (a) smollm-360m, batch 16, prompt 2048,
    64 tokens through ``repro_torch.launch.serve.generate`` (KV caches
    of 2112 rows; flash 32 x 64 = 2,048); (b) whisper-base, batch 8,
    4096 frames, prompt 64, 64 tokens through ``whisper.prefill`` and
    ``decode_step`` (flash 6 + 12 + 63 x 12 = 774); (c) xlstm-125m,
    batch 4, prompt 256, 32 tokens (no kernel); (d) zamba2-2.7b, 12 of
    its 54 blocks, batch 2, prompt 256, 32 tokens (287 steps, flash 2
    sites x 287 = 574; the SSM steps ``ssd_recurrent``).  Held: the KV caches'
    bytes = 2 x layers x B x max_len x Hkv x D x 2 exactly; smollm's and
    whisper's prefill logits against the same model without a cache at
    ``FLASH_BF16_REL`` (the same kernel tiles: equal); every step's
    logits against a teacher-forced run of the dense attention on the
    same tokens, the last step's against the model without a cache over
    prompt and generated tokens; xLSTM's and Zamba2's logits after the
    prompt's steps against ``forward`` over the prompt -- in bf16 at
    ``SERVE_BF16_BAR`` (``FLASH_BF16_REL``, or for smollm and Zamba2,
    whose 32 random layers and 54 blocks put bf16 rounding alone past
    1e-2, a bar set from the card's readings at those depths); then each model served
    again from the same weights in fp32, every step held to its fp32
    reference at ``SERVE_FP32_BAR`` (xLSTM's and Zamba2's first
    prompt_len steps against ``forward`` over the tokens fed).  Prints
    prefill seconds, decode ms per token, tokens/s, peak memory, cache
    bytes and the launches of the bf16 run, and bf16's distance from
    fp32 at the prefill; (e) every smoke key ``generate`` serves (seven
    LMs, xLSTM, Zamba2; fp32, batch 4, prompt 8, 16 tokens) on the card
    and on the CPU from the same params and prompts: tokens equal,
    logits within ``SERVE_SMOKE_BAR`` relative, flash once an attention
    call a step;
19. registry (``registry_bundles``, ``registry_smollm``,
    ``registry_internlm2``, ``registry_qwen3_int8``, ``registry_serve``),
    after phase 18, each run after checking that less than 1 GB is still
    allocated; bf16, seed-0 weights, full width, sequence 4096, global
    batch 16, every model from ``repro_torch.configs.get_arch`` and every
    step from ``repro_torch.train.steps``: (a) every one of the 13
    bundles: each supported shape's ``batch_struct`` (a train shape's
    also under a ``pp_1f1b`` plan of 16 microbatches) and ``cache_struct``
    on the meta device, their bytes and the bundle's param counts printed;
    (b) smollm-360m at 8 of its 32 layers (``scaled_cfg``) on its own
    ``train_4k`` plan (``pp_wave``, M=16),
    ``make_adapter`` with ``{"data": 1, "model": 4}`` (the folded
    closed-form wave at D=4) and ``build_pp_train_step``, 2 AdamW steps,
    against ``build_sharded_train_step`` over the bundle's ``loss_fn`` (a
    chunk of 2 rows at a time) on the same weights and batch, 2 steps:
    step 0's loss within 1e-4, the first gradient norm and the second loss
    within 1e-2, flash 8 x 16 x 2 = 256 a step (the reference 8 x 8 x
    2); (c) internlm2-20b at 4 of its 48 layers (``scaled_cfg``, about
    2.7e9 params) on its own ``train_4k`` plan (``pp_1f1b``, M=16): the
    linear closed form at D=4, 2 AdamW steps, step 0's loss within 1e-4
    of ``build_forward_step``'s on the same weights and batch, flash 4 x
    16 x 2 = 128 a step (the forward 4 x 8); (d) qwen3-moe-30b-a3b at 2
    of 48 layers, its ``train_4k`` plan with ``int8_optimizer``: one step
    of ``build_sharded_train_step`` at batch 2, then the loss again:
    finite, flash 4 + 2, the peak below the lm phase's fp32-AdamW run
    (43.91 GB), the moments' bytes equal to 2 x (n + 4 n / 256) with each
    leaf's padding; (e) a smollm-360m prefill of 16 prompts of 2048, then
    8 steps of ``build_sharded_serve_step`` on its ``decode_32k`` plan:
    tokens equal ``launch.serve.generate``'s from the same weights, flash
    256; the kernel phase holds flash at the two pipelines' microbatch of
    1 (rows ``registry ...``);
11. supervisor over ranks (``supervisor_phase``), run last, after phase
    14 (its UViT-H part is held to phase 13's losses), after releasing
    this process's memory; every generation is a world of rank processes
    of ``repro_torch.launch.train`` grouped by host, all on the one card
    over the staged gloo ring: (a) ``repro_torch.launch.supervisor.
    Supervisor`` at the JAX drill's plan and knobs (uvit-nano, 2 hosts x
    2 ranks, dp=2 pp=2, M=4, global batch 8, 12 steps, fp32 wire, a
    checkpoint every 4 steps, ``stall_timeout`` 8, ``miss_budget`` 2):
    ``hostdown@8:1`` must detect host 1, roll back to 8, shrink to
    (1, 2, 0) on one host of two ranks and finish; ``hang@6`` the same
    with the hang on the root host 0 within ``stall_timeout x
    miss_budget`` + 5 polls and a rollback to 4; every rank's losses of
    both generations at rtol 1e-4 to the one-process run of the plan's
    pipeline on the card (P=2, one replica); then the trainer's
    one-process worker mode, started by hand as the JAX trainer's hosts
    are (``worker_mode_drill``, no supervisor): two hosts, each a replica
    of the P=4 pipeline, through the ``start.g0`` FileBarrier and the
    commit barriers of steps 4 and 8, host 1 exits 42 after committing
    step 8, host 0 stops after step 10; one host of P=2 resumes step 8
    elastically; every host's losses at rtol 1e-4 to the same run;
    launches under path ``host workers``; (b) UViT-H at full width and
    the hybrid phase's depth (8 of 32 blocks) on its ZeRO-2 plan at V=1 (P=2 G=2, M=2, global
    batch 16, bf16) as 2 hosts x 2 ranks with ``hostdown@1:1`` and no
    checkpoint (3 steps, a save past the run, the relaunch ``stop@3``):
    hostdown on host 1, rollback (None), shrink to (1, 2, 0), one host of
    two ranks trains steps 0-2, every rank's losses within 1e-2 of phase
    13's ZeRO-2 steps, no step left in the checkpoint directory; both
    parts hold the card's free memory back within 1 GB after every
    teardown and print launch -> gen-live per generation, detection ->
    next gen-live, each rank's peak and step seconds; the ranks load the
    kernels phase 2 built (``REPRO_TORCH_BUILD_DIR`` inherited,
    ``REPRO_TORCH_NO_BUILD=1``; the build directory must hold the same
    files after the phase) and every rank log must name its CUDA device;
12. ranks (``ranks_phase``), after checking that less than 1 GB is still
    allocated: ``python -m torch.distributed.run --standalone
    --nproc-per-node 4 -m repro_torch.launch.train`` with phase 6's UViT-H
    plan and ``--ring gloo --device cuda --rank-report``: four processes,
    one per pipeline device, on the one card, the ring's payloads staged
    through pinned host memory, each running its own stage rows with the
    skip and flash kernels in its own process (they load what phase 2
    built).  Each rank runs 3 AdamW steps (the first one's
    forward+backward, read before its update, is the probe), then one
    forward+backward each of the skip-carry baseline and of the
    closed-form wave (``executor="closed_form"`` over the ranks) from the
    seed-0 params.  Held: the first loss to phase 6's
    at rtol 1e-5 and AdamW steps 1-2 at 2e-2; every gradient leaf's
    fingerprint (norm and 8 seeded random dots) to phase 6's step 0 at
    ||err||/||g|| <= 1e-2; the ring bytes, forward and backward, sent and
    received, to phase 6's ``HOP_BYTES`` live count a step (table walk,
    bf16 wire) and to the baseline phase's (skip-carry), exactly; the
    ranks' flash and skip launches of one forward+backward to phase 6's a
    step; the skip-carry loss to the table walk's at rtol 1e-5; the
    closed-form wave's loss to the table walk's at rtol 1e-5, its
    fingerprints to phase 6's step 0 at 1e-2, its ring bytes to the table
    walk's and ``HOP_BYTES``' live count, exactly, its flash and skip
    launches to phase 6's a step.  Prints
    each rank's peak memory beside Eq. 14's per-device prediction, the
    step seconds, and that NCCL was not run (one card);
12b. lm ranks (``lm_ranks_phase``), after phase 12: smollm-360m at full
    width, 8 of its 32 layers (``LM_LAYERS``; S=4096, global batch 16,
    bf16, the ``lm`` phase's seed-0 weights and batch) on the JAX
    ``wave-zero2`` config's plan shape (folded wave, P=2, dp=2, ZeRO-2, M=8) as four rank
    processes of this script (``--lm-rank``) on the one card, gloo staged
    through pinned host memory, 2 AdamW steps.  Held: the weights' and
    batch's digest to the ``lm`` phase's; the losses to its non-pipeline
    ``lm_loss`` + AdamW reference, every step at 1e-4; every rank's
    gradient finite every step (no update skipped) and its step-0 norm
    over the grid to the reference's at 1e-2; each replica's ring bytes to its live hops x a microbatch's activation;
    each rank's data-group bytes and calls of a step to ``hybrid_bytes``;
    the flash launches of a step to the tables' count for both replicas.
    The ranks' steps come from ``build_pp_train_step`` over the rank grid
    on that ``CompiledPipeline``.  Prints each rank's step seconds and
    peaks; rank logs in ``chiprun_out/lm_ranks.r<rank>.log``;
12c. sharded ranks (``sharded_ranks_phase``), after 12b: the JAX package's
    sharded strategy over a (data=2, model=2) grid of four rank processes
    of this script (``--sharded-rank``) on the one card, gloo staged
    through pinned host memory.  The SDv2 UNet at full width
    (1,839,817,728 params, bf16, the norm leaves fp32, flash on) on its own
    ``train_4k`` plan (FSDP over model x data, batch over data), global
    batch 16 (8 rows a data replica), 2 AdamW steps through
    ``build_sharded_train_step`` over the grid, held to the one-process
    step on the same weights, batch and DDPM draws (run first, and freed
    before the ranks start): every rank's loss equal, step 0's at 1e-3
    and step 1's at 1e-2, the step-0 gradient norm over the grid at 1e-2,
    every rank's gradient finite, each rank's block of every sharded leaf
    after the last step within 1e-2 (relative norm) of the reference's
    same block (a zero-drawn bias: at most 1e-2 of its entries more than
    lr off), flash 32 times a step on every rank, each rank's FSDP group
    bytes and calls by collective equal to their arithmetic from the
    specs.  whisper-base at full width on its ``prefill_32k`` plan
    (``build_forward_step``, B=8, 4096 frames) and ``decode_32k`` plan
    (``build_sharded_serve_step``, 16 greedy steps, B=8, 4 rows a data
    replica; FSDP over model, batch over data): in fp32 the loss at 1e-5
    and every token equal to the one-process steps' (bf16 printed).
    Then tensor parallelism over ``model`` in the same world
    (``TP_RUNS``; ``_tp_rank``, held by ``_tp_check`` to the one-process
    steps the parent ran before the ranks, ``_tp_reference``), at full
    width and depth, seed-0 weights: h2o-danube-1.8b's ``train_4k`` (bf16,
    2 AdamW steps, S=4096, global batch 4; TP over model, FSDP over data),
    ``prefill_32k`` (bf16, one forward, S=32768, global batch 2) and
    ``decode_32k`` (bf16, a 4160-token prompt prefilled through TP into a
    32768-row cache, 16 greedy serve steps, batch 4); smollm-360m's
    ``prefill_32k`` (fp32, S=4096) and ``decode_32k`` (fp32, a 2048-token
    prompt, 16 steps, batch 4).  Bars: train
    as the UNet's (losses, step-0 norm, every TP, FSDP and whole block
    after the last step); a forward's loss at 1e-5 (fp32) or 1e-3 (bf16);
    the prefill's logits and each rank's cache block of the prompt rows
    at 1e-5 (fp32) or 5e-2 (bf16); fp32 tokens all equal (bf16 printed);
    each step's model group bytes and calls by collective equal to
    ``lm_traffic`` (no all-gather of a weight's TP dim but the tied
    matrix), the train step's data group to ``_tp_data_traffic``; flash
    the rank's head runs times the layers a step (twice in a train step:
    remat).  Prints each rank's step seconds, peak and gloo seconds; rank
    logs in ``chiprun_out/sharded_ranks.r<rank>.log``;
13. hybrid (``hybrid_phase``), after checking that less than 1 GB is
    still allocated: the tuner's own N=4 plan for UViT-H at full width,
    its depth cut to 8 of its 32 blocks (``--layers``, to keep the
    script's time: this phase's gloo collectives scale with the params)
    (P=2, G=2, V=2, M=2; global batch 16, bf16) as ``torchrun
    --nproc-per-node 4 ... --dp 2 --pp 2 --interleave 2 --zero-stage Z
    --ring gloo --device cuda --rank-report``, at ZeRO-1 and then ZeRO-2:
    two data replicas of a two-device pipeline, four processes on the one
    card, the ring and the data group staged through pinned host memory;
    before them the same plan in one process (one data replica, the whole
    batch: ``HOP_BYTES``, launches, losses and step 0's fingerprints).
    ZeRO-0 is not run: the phase holds the two sharded stages (Eq. 14 of
    each stage printed).  Held: P, G, V and M are the tuner's
    N=4 choice, and the ranks' cuts (the trainer's, on roofline costs;
    the tuner's, on the plan phase's measured costs, are printed beside)
    the one-process run's; every rank's step-0 loss to that run's at
    rtol 1e-2 (bf16); every gradient leaf's fingerprint, gathered
    whole, to its step 0 at ||err||/||g|| <= 2e-2; ZeRO-1's and ZeRO-2's
    losses of steps 0-2 within 1e-3; the data group's bytes and calls by
    collective, of the probe and of every step, to their arithmetic from
    the step tables and the leaves' shapes, exactly; the ring's bytes to
    the one-process ``HOP_BYTES`` live count a step, exactly; the probe's
    flash and skip launches over the ranks to twice the one-process
    step's; each rank's ZeRO-2 peak below its ZeRO-1 peak.  Prints each
    rank's peaks beside Eq. 14's per-device prediction at its stage, the
    step seconds and the collectives' host seconds; torchrun's output in
    ``chiprun_out/hybrid_zero{1,2}.log``.  The ZeRO-2 run also takes
    ``--ckpt-dir --ckpt-every 3 --steps 4 --faults stop@4``: it saves step
    3 (every rank writes its shard of the checkpoint), trains
    step 3 and stops without a final save;
14. rank checkpoint (``rank_checkpoint_phase``): four ranks of phase 12's
    plan (P=4, one replica, ZeRO-0) at the hybrid phase's depth resume
    that checkpoint under
    ``torchrun --resume --rank-report``, elastically (the fingerprints
    differ), and train step 3.  Held: every rank's save landed at the
    first attempt; every rank restored step 3 elastically; bitwise, by
    SHA-256 in the rank against SHA-256 of the same range of the saved
    member (hashed here): each saving ZeRO-2 rank's pieces at the save
    (its shard of each block), each resumed rank's rows after the
    restore, and every edge leaf; each rank read no more than its blocks
    and the edge leaves, and the ranks hashed every shard once; the
    resumed step-3 loss within 1e-2 of the saving world's; flash and
    skip launched.  Prints the checkpoint's bytes, each writer's gather
    bytes and seconds, write, hash and GC seconds, each rank's blocking
    seconds at the save, each rank's restore seconds and bytes read;
    torchrun's output in ``chiprun_out/rank_checkpoint.log``; the
    directory is removed;
15. the ``kernels`` JSON line (each kernel's launches by path: ``plan``,
    ``baseline``, ``skipvit train``, ``skipvit wave-asym``, ``lm
    smollm-360m wave``, ``lm smollm-360m linear``, ``lm
    qwen3-moe-30b-a3b``, ``lm smoke``, ``recurrent whisper-base``,
    ``recurrent xlstm-125m``, ``recurrent zamba2-2.7b``, ``recurrent
    smoke``, ``serve smollm-360m``, ``serve whisper-base``, ``serve
    xlstm-125m``, ``serve zamba2-2.7b``, ``serve smoke``, ``registry
    smollm-360m pp_wave``, ``registry smollm-360m reference``, ``registry
    internlm2-20b pp_1f1b``, ``registry internlm2-20b forward``,
    ``registry qwen3-moe-30b-a3b int8``, ``registry smollm-360m serve``,
    ``ranks``, ``lm ranks``, ``sharded ranks``, ``hybrid``, ``rank
    checkpoint``, ``supervisor ranks`` and ``host workers``, the last
    seven read from the ranks' and the workers' result files, among
    them), then the device line as the last line.

The full record goes to ``chiprun_out/chip_smoke.json``.  Without a CUDA
device the script exits 1 at once and prints no result.
"""
import argparse
import gc
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
HBM_BYTES_PER_S = 3.35e12
TRAIN_ARGV = ["--pipeline", "--devices", "4", "--microbatches", "8",
              "--global-batch", "16", "--steps", "4", "--log-every", "1",
              "--device", "cuda"]
TRAIN_ARCHS = ("uvit-h", "hunyuan-dit")      # in this order, one at a time
# the SDv2 UNet at full width, the whole model in one step (no --pipeline)
UNET_ARGV = ["--arch", "sdv2-unet-full", "--global-batch", "16", "--steps",
             "4", "--log-every", "1", "--device", "cuda"]
UNET_FLASH_PER_STEP = 32     # 16 attention blocks, self + cross each
SOURCES = {   # kernel -> (CUDA source, the TPU kernel it replaces)
    "skip_concat_matmul": ("src/repro_torch/kernels/csrc/skip_matmul.cu",
                           "src/repro/kernels/skip_matmul/kernel.py:40"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:64"),
    "gated_linear_scan": ("src/repro_torch/kernels/csrc/linear_scan.cu",
                          "src/repro/kernels/linear_scan/kernel.py:45"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


TIMED_MS = 250.0     # a timing's span: calls over 12.5 ms take fewer than 20


def time_ms(torch, fn, warmup: int = 3, iters: int = 20,
            graph: bool = False) -> float:
    """Mean ms per call of ``fn``: CUDA events around ``iters`` calls as
    issued from Python, so a call whose host cost exceeds its device time
    is timed by the host (a call slower than ``TIMED_MS / iters``: over as
    many calls as fit in ``TIMED_MS``, at least 3).  With ``graph`` the
    calls are captured in one CUDA graph and its replay is timed instead:
    the device's time for the work alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # a slow call (a plain version) is timed over fewer calls, at least 3,
    # about TIMED_MS in all: its mean moves less than its own spread
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = (time.perf_counter() - t0) * 1e3
    iters = max(3, min(iters, int(TIMED_MS / max(one, 1e-3))))
    run = fn
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        run = g.replay
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    if graph:
        run()
    else:
        for _ in range(iters):
            run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """Least time in ms: max(operations / peak, bytes / HBM rate), with the
    peak of the type the operations run in."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_close(torch, got, want, dtype: str, what: str,
                row_sum: bool = False) -> float:
    """rtol = atol = ``tol``.  ``row_sum`` (a weight gradient, summed over
    thousands of rows) sets atol to ``tol`` x max|want|: its entries near
    zero keep no relative precision when the sum is taken in another
    order."""
    tol = 1e-4 if dtype == "float32" else 2e-2
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    atol = tol * float(want.abs().max()) if row_sum else tol
    try:
        torch.testing.assert_close(got, want, rtol=tol, atol=atol)
    except AssertionError as e:
        fail(f"{what}: kernel disagrees with its plain version "
             f"(max abs err {err:.3e}, rtol={tol}, atol={atol:.3e}):\n{e}")
    return err


def rel_errs(torch, got: dict, want: dict, bar: float, what: str) -> tuple:
    """||got - want|| / ||want|| for every gradient by path, each at most
    ``bar`` (one zero in ``want`` must be zero in ``got``): bf16 rounds at
    every op, so an elementwise bound would measure bf16's own rounding.
    Returns the worst and its path."""
    if sorted(got) != sorted(want):
        fail(f"{what}: gradient leaves differ")
    worst, worst_k = 0.0, None
    for k, w in want.items():
        ref = float(torch.linalg.vector_norm(w.float()))
        err = float(torch.linalg.vector_norm(got[k].float() - w.float()))
        if ref == 0.0:
            if err != 0.0:
                fail(f"{what}: grad {k} is zero in the reference but not "
                     "here")
            continue
        if not err / ref <= bar:
            fail(f"{what}: grad {k} relative error {err / ref:.3e} > {bar}")
        if err / ref > worst:
            worst, worst_k = err / ref, k
    return worst, worst_k


# ---------------------------------------------------------------------------
# phase 3: kernels
# ---------------------------------------------------------------------------

def _ms(row: dict, key: str) -> str:
    """``key`` as issued and, beside it, as a graph replay; "none" where
    the row has no such call."""
    if row[f"{key}ms"] is None:
        return "none"
    dev = row[f"{key}device_ms"]
    return (f"{row[f'{key}ms']:.4f} ms"
            + (f" (device {dev:.4f})" if dev is not None else ""))


def _row_line(what: str, row: dict, lib_name: str) -> str:
    grads = row.get("grad_max_abs_err") or {}
    return (f"[kernels] {what}: max|err| {row['max_abs_err']:.3e}"
            + ("  grads " + " ".join(f"{k} {v:.3e}" for k, v in grads.items())
               if grads else "")
            + f"  kernel {_ms(row, '')}  plain {_ms(row, 'plain_')}"
            f"  {lib_name} {_ms(row, 'library_')}"
            f"  bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
            f"{row['bound_ms'] / row['device_ms']:.1%} of the device time)")


def _times(torch, kernel, plain, library) -> dict:
    """Each of the three timed as issued and as a graph replay."""
    out = {}
    for key, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        out[f"{key}ms"] = out[f"{key}device_ms"] = None
        if fn is not None:
            out[f"{key}ms"] = time_ms(torch, fn)
            out[f"{key}device_ms"] = time_ms(torch, fn, graph=True)
    return out


def check_skip_matmul(torch, rec) -> dict:
    """Returns the bf16 row of each train path's shape, by path."""
    from repro_torch.kernels.skip_matmul import (skip_concat_matmul,
                                                 skip_concat_matmul_cuda,
                                                 skip_concat_matmul_plain)
    rows, main = [], {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [  # path, M, D=N: b=2 and b=16 at UViT-H's 258 tokens, and
               # b=2 at Hunyuan-DiT's 1024 tokens; the plan phase's b=8
        ("uvit-h", 516, 2560), (None, 4128, 2560), ("hunyuan-dit", 2048, 2048),
        ("plan uvit-h", 2064, 2560), ("plan hunyuan-dit", 8192, 2048),
        ("hybrid uvit-h", 1032, 2560),   # a replica's microbatch, b=4
        ("uvit-nano", 12, 32),   # the supervisor drills' b=2 x 6 tokens
        ("uvit-nano dp=2", 6, 32)]   # a replica's b=1 of the drills' gen 0
    for dtype in ("bfloat16", "float32"):
        for path, M, D in cases:
            N = D
            dt = getattr(torch, dtype)
            h = torch.randn(M, D, device="cuda", generator=gen).to(dt)
            s = torch.randn(M, D, device="cuda", generator=gen).to(dt)
            w = (torch.randn(2 * D, N, device="cuda", generator=gen)
                 / math.sqrt(2 * D)).to(dt)
            what = f"skip_concat_matmul {dtype} M={M} D=N={D}"
            got = skip_concat_matmul_cuda(h, s, w)
            torch.cuda.synchronize()
            err = check_close(torch, got, skip_concat_matmul_plain(h, s, w),
                              dtype, what)
            # gradients: kernel forward + the op's matmul backward against
            # autograd through the plain version
            g = torch.randn(M, N, device="cuda", generator=gen).to(dt)
            ins = [x.clone().requires_grad_(True) for x in (h, s, w)]
            skip_concat_matmul(*ins).backward(g)
            ref = [x.clone().requires_grad_(True) for x in (h, s, w)]
            skip_concat_matmul_plain(*ref).backward(g)
            grad_err = {nm: check_close(torch, a.grad, b.grad, dtype,
                                        f"{what} {nm}", row_sum=nm == "dw")
                        for a, b, nm in zip(ins, ref, ("dh", "ds", "dw"))}
            del ins, ref, g
            times = _times(torch, lambda: skip_concat_matmul_cuda(h, s, w),
                           lambda: skip_concat_matmul_plain(h, s, w),
                           lambda: torch.cat([h, s], -1) @ w)
            esz = h.element_size()
            b_ms, b_by = bound(4.0 * M * D * N,
                               esz * (2 * M * D + 2 * D * N + M * N), dtype)
            row = dict(path=path, dtype=dtype, M=M, D=D, N=N,
                       max_abs_err=err, grad_max_abs_err=grad_err, **times,
                       device_tflops=4.0 * M * D * N / times["device_ms"] / 1e9,
                       bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
            log(_row_line(what, row, "cat+matmul"))
            if dtype == "bfloat16" and path:
                main[path] = row             # the train step's shape
            del h, s, w, got
    # the supervisor's UViT-H ranks: gen 0 (dp=2) runs a replica's b=4 of
    # the hybrid plan's microbatch, gen 1 (dp=1) the whole b=8 of the plan
    main.update({"supervisor uvit-h gen 0": main["hybrid uvit-h"],
                 "supervisor uvit-h gen 1": main["plan uvit-h"]})
    rec["skip_concat_matmul"] = rows
    return main


FLASH_BF16_REL = 1e-2    # bf16 flash vs fp32 plain, relative Frobenius
# rows whose path runs bf16 alone: no fp32 row (the script's time)
FLASH_BF16_ONLY = {"tp h2o-danube-1.8b train", "tp h2o-danube-1.8b decode"}


FLASH_CASES = [  # path, B, S, T, Hq, Hkv, D, causal, window
        ("uvit-h", 2, 258, 258, 20, 20, 128, False, None),      # b=2
        ("hunyuan-dit", 2, 1024, 1024, 16, 16, 128, False, None),
        ("hunyuan-dit cross", 2, 1024, 77, 16, 16, 128, False, None),
        # the plan phase's b=8: its block profiles and its steps
        ("plan uvit-h", 8, 258, 258, 20, 20, 128, False, None),
        ("plan hunyuan-dit", 8, 1024, 1024, 16, 16, 128, False, None),
        ("plan hunyuan-dit cross", 8, 1024, 77, 16, 16, 128, False, None),
        # the hybrid phase: a data replica's microbatch of UViT-H, b=4
        ("hybrid uvit-h", 4, 258, 258, 20, 20, 128, False, None),
        (None, 1, 300, 300, 8, 2, 64, True, 96),          # causal+win+GQA
        # the SDv2 UNet's train step (sdv2-unet-full, B=16, 8 heads): self
        # and cross-attention over 77 text tokens at 16x16 (head dim 112),
        # 8x8 and 4x4 (level 3 and the middle block; head dim 224)
        ("sdv2-unet L1 self", 16, 256, 256, 8, 8, 112, False, None),
        ("sdv2-unet L1 cross", 16, 256, 77, 8, 8, 112, False, None),
        ("sdv2-unet L2 self", 16, 64, 64, 8, 8, 224, False, None),
        ("sdv2-unet L2 cross", 16, 64, 77, 8, 8, 224, False, None),
        ("sdv2-unet L3+mid self", 16, 16, 16, 8, 8, 224, False, None),
        ("sdv2-unet L3+mid cross", 16, 16, 77, 8, 8, 224, False, None),
        # the sharded ranks phase: the UNet's rows of a data replica, B=8,
        # and whisper-base's, B=4 (the encoder over 4096 frames, the
        # decoder's causal self-attention over 447 tokens, its cross over
        # the frames; a serve step's self-attention over the cache of 81
        # and its cross over the frames)
        ("sharded sdv2-unet L1 self", 8, 256, 256, 8, 8, 112, False, None),
        ("sharded sdv2-unet L1 cross", 8, 256, 77, 8, 8, 112, False, None),
        ("sharded sdv2-unet L2 self", 8, 64, 64, 8, 8, 224, False, None),
        ("sharded sdv2-unet L2 cross", 8, 64, 77, 8, 8, 224, False, None),
        ("sharded sdv2-unet L3+mid self", 8, 16, 16, 8, 8, 224, False,
         None),
        ("sharded sdv2-unet L3+mid cross", 8, 16, 77, 8, 8, 224, False,
         None),
        ("sharded whisper-base encoder", 4, 4096, 4096, 8, 8, 64, False,
         None),
        ("sharded whisper-base decoder", 4, 447, 447, 8, 8, 64, True, None),
        ("sharded whisper-base cross", 4, 447, 4096, 8, 8, 64, False, None),
        ("sharded whisper-base decode", 4, 1, 81, 8, 8, 64, True, None, 70,
         71),
        ("sharded whisper-base cross decode", 4, 1, 4096, 8, 8, 64, False,
         None),
        # the small models of the skipvit and supervisor phases, b=2
        ("uvit-nano", 2, 6, 6, 2, 2, 16, False, None),
        ("uvit-nano dp=2", 1, 6, 6, 2, 2, 16, False, None),
        ("skipvit", 2, 18, 18, 4, 4, 16, False, None),
        # the lm phase: a smollm-360m microbatch of its pipelines (b=2 of
        # 16) and qwen3-moe-30b-a3b's batch 2, causal GQA at sequence 4096
        ("lm smollm-360m", 2, 4096, 4096, 15, 5, 64, True, None),
        ("lm qwen3-moe-30b-a3b", 2, 4096, 4096, 32, 4, 128, True, None),
        # the lm phase's smoke keys through the trainer, batch 4 of 32
        # tokens, heads of 16: GQA 4:2 (smollm, internlm2, qwen3), its
        # window of 8 (danube), MQA 4:1 (granite), and 8 vision-prefix rows
        # before the 32 tokens (internvl2)
        ("lm smoke GQA", 4, 32, 32, 4, 2, 16, True, None),
        ("lm smoke window", 4, 32, 32, 4, 2, 16, True, 8),
        ("lm smoke MQA", 4, 32, 32, 4, 1, 16, True, None),
        ("lm smoke prefix", 4, 40, 40, 4, 2, 16, True, None),
        # the recurrent phase's whisper-base, batch 8, 8 heads of 64: the
        # encoder's self-attention over 4096 frames, the decoder's causal
        # self-attention over 447 tokens (a partial last tile) and its
        # cross-attention over the encoded frames
        ("whisper-base encoder", 8, 4096, 4096, 8, 8, 64, False, None),
        ("whisper-base decoder", 8, 447, 447, 8, 8, 64, True, None),
        ("whisper-base cross", 8, 447, 4096, 8, 8, 64, False, None),
        # its smoke key through the trainer, batch 4: 4 heads of 8 over 12
        # frames and 9 tokens
        ("recurrent smoke whisper encoder", 4, 12, 12, 4, 4, 8, False, None),
        ("recurrent smoke whisper decoder", 4, 9, 9, 4, 4, 8, True, None),
        ("recurrent smoke whisper cross", 4, 9, 12, 4, 4, 8, False, None),
        # head dim 80, the tensor-core route padded to 128 columns:
        # zamba2-2.7b's shared attention at the recurrent phase's training
        # shape (causal, as its config), and h2o-danube-1.8b's full shape
        # (GQA 32:8, window 4096)
        ("zamba2-2.7b shared attention", 2, 4096, 4096, 32, 32, 80, True,
         None),
        ("h2o-danube-1.8b", 2, 4096, 4096, 32, 8, 80, True, 4096),
        # the sharded ranks phase's tensor parallelism, a rank's heads:
        # h2o-danube-1.8b's 16 q heads over 4 kv heads (D=80, window
        # 4096), a train step's B=2 of 4096 and a decode step over the
        # rank's block of the 32768-row cache (after the 4160-token
        # prompt; its prefill's 32768 tokens: FLASH_LONG_CASES), bf16
        # alone (``FLASH_BF16_ONLY``); smollm-360m's runs of heads (two
        # whole GQA groups, 6:2, and two heads of a group, 2:1, at D=64)
        # over a decode step's copy of the valid rows of their kv heads,
        # and its fp32 prefill's B=1 of 4096
        ("tp h2o-danube-1.8b train", 2, 4096, 4096, 16, 4, 80, True, 4096),
        ("tp h2o-danube-1.8b decode", 2, 1, 32768, 16, 4, 80, True, 4096,
         4168, 4169),
        ("tp smollm-360m decode, whole groups", 2, 1, 2057, 6, 2, 64, True,
         None, 2056, None),
        ("tp smollm-360m decode, part of a group", 2, 1, 2057, 2, 1, 64,
         True, None, 2056, None),
        ("tp smollm-360m prefill, whole groups", 1, 4096, 4096, 6, 2, 64,
         True, None),
        ("tp smollm-360m prefill, part of a group", 1, 4096, 4096, 2, 1,
         64, True, None),
        # the serve phase, over KV caches (+ q_offset, kv_valid_len): the
        # kernel reads the whole cache of T rows in place, its key loop
        # stopping at the valid length.  smollm-360m's prefill (batch 16,
        # prompt 2048 in a cache of 2112) and a decode step near its end;
        # whisper-base's decoder self-attention at a decode step (cache of
        # 128) and its cross-attention of one token over the 4096 frames;
        # zamba2-2.7b's shared attention at a decode step (cache of 288)
        ("serve smollm-360m prefill", 16, 2048, 2112, 15, 5, 64, True, None,
         0, 2048),
        ("serve smollm-360m decode", 16, 1, 2112, 15, 5, 64, True, None,
         2100, 2101),
        ("serve whisper-base decode", 8, 1, 128, 8, 8, 64, True, None, 100,
         101),
        ("serve whisper-base cross decode", 8, 1, 4096, 8, 8, 64, False,
         None),
        ("serve zamba2-2.7b decode", 2, 1, 288, 32, 32, 80, True, None, 270,
         271),
        # the registry phase's pipelines, a microbatch of 1 of 16 at
        # sequence 4096: smollm-360m's pp_wave (causal GQA 15:5 at 64) and
        # internlm2-20b's pp_1f1b (causal GQA 48:8 at 128)
        ("registry smollm-360m", 1, 4096, 4096, 15, 5, 64, True, None),
        ("registry internlm2-20b", 1, 4096, 4096, 48, 8, 128, True, None),
]


def check_flash(torch, rec) -> dict:
    """Returns the bf16 row of each path's shape, by path."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention,
                                                     flash_attention_cuda,
                                                     flash_route)
    from repro_torch.kernels.flash_attention.ops import _mask
    rows, main = [], {}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for path, B, S, T, Hq, Hkv, D, causal, window, *cache in FLASH_CASES:
        q_off, valid = cache or (0, None)
        args = (causal, window, q_off, valid)
        for dtype in ("bfloat16",) + (() if path in FLASH_BF16_ONLY
                                      else ("float32",)):
            dt = getattr(torch, dtype)
            q = torch.randn(B, S, Hq, D, device="cuda", generator=gen).to(dt)
            k = torch.randn(B, T, Hkv, D, device="cuda", generator=gen).to(dt)
            v = torch.randn(B, T, Hkv, D, device="cuda", generator=gen).to(dt)
            what = (f"flash_attention {dtype} B={B} S={S} T={T} Hq={Hq} "
                    f"Hkv={Hkv} D={D} causal={causal} window={window}"
                    + (f" q_offset={q_off} kv_valid_len={valid}" if cache
                       else ""))
            got = flash_attention_cuda(q, k, v, *args)
            torch.cuda.synchronize()
            err = check_close(torch, got, attention_plain(q, k, v, *args),
                              dtype, what)
            rel = None
            if dtype == "bfloat16":
                # bf16 outputs are small where a row averages many keys
                # (causal, long S): also held to fp32 attention of the
                # same inputs, relative to the data's own scale
                want = attention_plain(q.float(), k.float(), v.float(),
                                       *args)
                rel = float(torch.linalg.vector_norm(got.float() - want)
                            / torch.linalg.vector_norm(want))
                if not rel <= FLASH_BF16_REL:
                    fail(f"{what}: ||flash - fp32 plain|| / ||fp32 plain|| "
                         f"{rel:.3e} > {FLASH_BF16_REL}")
                del want
            g = torch.randn(B, S, Hq, D, device="cuda", generator=gen).to(dt)
            ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
            flash_attention(*ins, causal, window, q_off, valid).backward(g)
            ref = [x.clone().requires_grad_(True) for x in (q, k, v)]
            attention_plain(*ref, *args).backward(g)
            grad_err = {nm: check_close(torch, a.grad, b.grad, dtype,
                                        f"{what} {nm}")
                        for a, b, nm in zip(ins, ref, ("dq", "dk", "dv"))}
            del ins, ref, g
            # SDPA computes the same function: is_causal where the mask is
            # the plain causal one, else with the boolean mask (a window,
            # a cache's offset and valid length)
            qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
            vis = _mask(S, T, causal, window, "cuda", q_off, valid)
            sdpa_mask = None if window is None and not cache else vis

            def library():
                return F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=sdpa_mask,
                    is_causal=causal and sdpa_mask is None,
                    enable_gqa=Hq != Hkv)
            times = _times(
                torch, lambda: flash_attention_cuda(q, k, v, *args),
                lambda: attention_plain(q, k, v, *args), library)
            # score pairs this data needs: every (query, visible key); the
            # bytes: q and out, and K and V once -- over a cache, its valid
            # rows only
            pairs = int(vis.sum())
            esz = q.element_size()
            kv_rows = T if valid is None else valid
            b_ms, b_by = bound(
                4.0 * B * Hq * pairs * D,
                esz * (2 * B * S * Hq * D + 2 * B * kv_rows * Hkv * D), dtype)
            row = dict(path=path, dtype=dtype, B=B, S=S, T=T, Hq=Hq, Hkv=Hkv,
                       D=D, causal=causal, window=window, q_offset=q_off,
                       kv_valid_len=valid,
                       route=flash_route(dt, D), max_abs_err=err,
                       rel_err_vs_fp32=rel, grad_max_abs_err=grad_err,
                       **times,
                       device_tflops=(4.0 * B * Hq * pairs * D
                                      / times["device_ms"] / 1e9),
                       bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
            log(_row_line(f"{what} route={row['route']}"
                          + (f" (vs fp32 plain: rel {rel:.3e})" if rel
                             is not None else ""), row, "sdpa"))
            if dtype == "bfloat16" and path:
                main[path] = row
            del q, k, v, got, qh, kh, vh, vis, sdpa_mask
    main.update({"supervisor uvit-h gen 0": main["hybrid uvit-h"],
                 "supervisor uvit-h gen 1": main["plan uvit-h"]})
    rec["flash_attention"] = rows
    return main


# the sharded ranks phase's TP prefill of 32768 tokens, a rank's heads,
# bf16: path, B, S, Hq, Hkv, D, window (causal)
FLASH_LONG_CASES = [
    ("tp h2o-danube-1.8b prefill", 1, 32768, 16, 4, 80, 4096),
]
FLASH_LONG_ROWS = 256        # query rows held at each end of S


def check_flash_long(torch, rec) -> None:
    """Flash at S=32768 (``FLASH_LONG_CASES``, bf16, causal): the plain
    version's S x S scores do not fit on the card, so the kernel's output
    rows ``[0, 256)`` and ``[S - 256, S)`` of the whole-shape launch are
    held to the plain version of those query rows (``q_offset``) over
    every key, at ``check_close``'s bf16 bar and against fp32 plain at
    ``FLASH_BF16_REL``.  Timed as issued and as a graph replay beside SDPA
    over K/V repeated to the q heads (outside the timing), with the
    boolean mask where a window is set, on its fused backends only (None
    where they refuse: the math backend's fp32 scores would not fit); no
    plain time.  The backward recomputes through the plain version, which
    ``check_flash`` holds at the shorter shapes.  Rows appended to
    ``rec["flash_attention"]``."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention_cuda,
                                                     flash_route)
    from repro_torch.kernels.flash_attention.ops import _mask
    gen = torch.Generator(device="cuda").manual_seed(2)
    n = FLASH_LONG_ROWS
    for path, B, S, Hq, Hkv, D, window in FLASH_LONG_CASES:
        q, k, v = (torch.randn(B, S, H, D, device="cuda",
                               generator=gen).to(torch.bfloat16)
                   for H in (Hq, Hkv, Hkv))
        what = (f"flash_attention bfloat16 B={B} S={S} T={S} Hq={Hq} "
                f"Hkv={Hkv} D={D} causal=True window={window}")
        got = flash_attention_cuda(q, k, v, True, window)
        torch.cuda.synchronize()
        err, rel = 0.0, 0.0
        for lo in (0, S - n):
            part = got[:, lo:lo + n]
            want = attention_plain(q[:, lo:lo + n], k, v, True, window,
                                   q_offset=lo)
            err = max(err, check_close(torch, part, want, "bfloat16",
                                       f"{what} rows {lo}:{lo + n}"))
            want = attention_plain(q[:, lo:lo + n].float(), k.float(),
                                   v.float(), True, window, q_offset=lo)
            rel = max(rel, _rel(torch, part, want))
            del want
        if not rel <= FLASH_BF16_REL:
            fail(f"{what}: ||flash - fp32 plain|| / ||fp32 plain|| {rel:.3e}"
                 f" > {FLASH_BF16_REL} on the held rows")
        del got
        g = Hq // Hkv
        qh, kh, vh = (x.transpose(1, 2) for x in (
            q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)))
        vis = _mask(S, S, True, window, "cuda")
        mask = vis if window is not None else None
        pairs = int(vis.sum())
        del vis

        def library():
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                              SDPBackend.EFFICIENT_ATTENTION]):
                return F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask, is_causal=mask is None)
        try:
            library()
        except RuntimeError as exc:
            log(f"[kernels] {what}: SDPA's fused backends refuse it ({exc})"
                "; library_ms None")
            library = None
        times = _times(torch, lambda: flash_attention_cuda(q, k, v, True,
                                                           window),
                       None, library)
        b_ms, b_by = bound(4.0 * B * Hq * pairs * D,
                           2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D),
                           "bfloat16")
        row = dict(path=path, dtype="bfloat16", B=B, S=S, T=S, Hq=Hq,
                   Hkv=Hkv, D=D, causal=True, window=window, q_offset=0,
                   kv_valid_len=None, route=flash_route(torch.bfloat16, D),
                   max_abs_err=err, rel_err_vs_fp32=rel,
                   held_rows=f"[0, {n}) and [{S - n}, {S})", **times,
                   device_tflops=(4.0 * B * Hq * pairs * D
                                  / times["device_ms"] / 1e9),
                   bound_ms=b_ms, bound_by=b_by)
        rec["flash_attention"].append(row)
        log(_row_line(f"{what} route={row['route']} (rows {row['held_rows']}"
                      f" held; vs fp32 plain: rel {rel:.3e})", row,
                      "sdpa, K/V repeated"))
        del q, k, v, qh, kh, vh, mask


# zamba2's carry across chunks: batch 2, 4096 / 128 chunks, H*N*P
ZAMBA2_CARRY = "zamba2-2.7b chunk carry, T=32"
SCAN_SHAPES = {"zamba2-2.7b mamba2, T=4096": (4, 4096, 5120),
               "wide, R=32 T=2048": (32, 2048, 5120),
               ZAMBA2_CARRY: (2, 32, 80 * 64 * 64)}
# the decay a of each check: sigmoid(normal), whose product over a warp's 16
# steps is ~3e-6, so h hardly depends on what came before; and
# exp(-0.01 softplus(normal)), near 1 as Mamba2's exp(dt A) are, whose
# product over a 64-step chunk is ~0.6, so the carry from warp to warp and
# the look-back over many chunks decide h.  Timed on the second.
SCAN_DECAYS = ("sigmoid", "near 1")


def scan_inputs(torch, gen, R, T, C, dtype_a, dtype_x, decay):
    """(a, x, g) of the scan on the card: a by ``decay`` (``SCAN_DECAYS``)
    in ``dtype_a``, x and the cotangent g normal in ``dtype_x``.  Near 1,
    x and g are scaled by sqrt(1 - a^2), as Mamba2 scales its input by dt,
    so that h and the adjoint dX keep unit variance: unscaled, both reach
    ~40, and two fp32 summation orders of the same scan (the plain loop
    against an fp64 one, too) then differ by more than the checks' 1e-4
    (``test_chunked_scan_is_no_less_accurate_than_the_loop``)."""
    v = torch.randn(R, T, C, device="cuda", generator=gen)
    x, g = (torch.randn(R, T, C, device="cuda", generator=gen)
            for _ in range(2))
    if decay == "sigmoid":
        a = torch.sigmoid(v)
    else:
        a = torch.exp(-0.01 * torch.nn.functional.softplus(v))
        x, g = (t * torch.sqrt(1 - a * a) for t in (x, g))
    return a.to(dtype_a), x.to(dtype_x), g.to(dtype_x)


def check_scan(torch, rec) -> dict:
    """The gated linear scan.  Each check runs at both decays of
    ``SCAN_DECAYS``.  (1) The
    op's forward and backward (one kernel launch each) against the plain
    versions at T=512 and at a ragged shape, for each pair of dtypes of a
    and x (bf16 and fp32, and both mixed pairs: the mixed ones against the
    plain transcription of the JAX VJP, which rounds g to a's dtype where
    autograd through the plain forward does not).  (2) At zamba2-2.7b's
    Mamba2 width (R=4 rows of C=5120 channels, T=4096), at a wide shape
    (R=32, T=2048) and at the shape of zamba2's carry across chunks on the
    recurrent phase's path (R=2, T=32 chunks, C = 80 heads x 64 x 64;
    shorter than one of the kernel's chunks), each of bf16 and fp32: the
    op's forward and backward, and the forward and backward kernels called
    directly, each against its plain version on the same inputs; on the
    decay near 1, each kernel then timed beside its bound (forward 3 N
    elements moved, backward 5 N).  Returns the fp32 forward row at the
    carry's shape, the path's; the op's launches here are comparisons
    (``rec["gated_linear_scan_op_launches"]``), not a path's."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.linear_scan import (gated_linear_scan,
                                                 gated_linear_scan_bwd_cuda,
                                                 gated_linear_scan_bwd_plain,
                                                 gated_linear_scan_cuda,
                                                 gated_linear_scan_plain)
    rows, main, launches = [], None, 0
    gen = torch.Generator(device="cuda").manual_seed(2)

    def op(a, x, g):
        """The op's h and (da, dx), counting its launches."""
        nonlocal launches
        before = LAUNCHES["gated_linear_scan"]
        ins = [t.clone().requires_grad_(True) for t in (a, x)]
        h = gated_linear_scan(*ins)
        h.backward(g)
        torch.cuda.synchronize()
        launches += LAUNCHES["gated_linear_scan"] - before
        return h.detach(), [t.grad for t in ins]

    for dta, dtx in (("bfloat16", "bfloat16"), ("float32", "float32"),
                     ("float32", "bfloat16"), ("bfloat16", "float32")):
        # rtol = atol = 2e-2 where either side is bf16
        tol_dtype = "float32" if dta == dtx == "float32" else "bfloat16"
        for (R, T, C), decay in itertools.product(
                ((4, 512, 5120), (3, 300, 200)), SCAN_DECAYS):
            a, x, g = scan_inputs(torch, gen, R, T, C, getattr(torch, dta),
                                  getattr(torch, dtx), decay)
            what = (f"gated_linear_scan op a {dta} x {dtx} R={R} T={T} C={C} "
                    f"a {decay}")
            h, got = op(a, x, g)
            want_h = gated_linear_scan_plain(a, x)
            err = check_close(torch, h, want_h, tol_dtype, f"{what} h")
            if dta == dtx:
                ref = [t.clone().requires_grad_(True) for t in (a, x)]
                gated_linear_scan_plain(*ref).backward(g)
                want = [t.grad for t in ref]
            else:
                want = gated_linear_scan_bwd_plain(a, want_h, g)
            grad_err = {nm: check_close(torch, i, r, tol_dtype, f"{what} {nm}")
                        for i, r, nm in zip(got, want, ("da", "dx"))}
            rec.setdefault("gated_linear_scan_op", []).append(
                dict(dtype_a=dta, dtype_x=dtx, R=R, T=T, C=C, decay=decay,
                     max_abs_err=err, grad_max_abs_err=grad_err))
            log(f"[kernels] {what}: h {err:.3e}, grads "
                + " ".join(f"{k} {v:.3e}" for k, v in grad_err.items()))
            del a, x, g, h, got, want, want_h

    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for shape_name, (R, T, C) in SCAN_SHAPES.items():
            n = R * T * C
            for decay in SCAN_DECAYS:
                a, x, g = scan_inputs(torch, gen, R, T, C, dt, dt, decay)
                esz = a.element_size()
                what = f"gated_linear_scan {dtype} R={R} T={T} C={C} a {decay}"
                # the op, then each kernel called directly, against the
                # plain versions on the same inputs
                h, (op_da, op_dx) = op(a, x, g)
                want_h = gated_linear_scan_plain(a, x)
                want_da, want_dx = gated_linear_scan_bwd_plain(a, h, g)
                da, dx = gated_linear_scan_bwd_cuda(a, h, g)
                err = {"forward": max(
                    check_close(torch, h, want_h, dtype, f"{what} op h"),
                    check_close(torch, gated_linear_scan_cuda(a, x), want_h,
                                dtype, f"{what} forward kernel")),
                       "backward": max(
                    check_close(torch, op_da, want_da, dtype, f"{what} op da"),
                    check_close(torch, op_dx, want_dx, dtype, f"{what} op dx"),
                    check_close(torch, da, want_da, dtype,
                                f"{what} backward kernel da"),
                    check_close(torch, dx, want_dx, dtype,
                                f"{what} backward kernel dx"))}
                del op_da, op_dx, da, dx, want_h, want_da, want_dx
                if decay != SCAN_DECAYS[-1]:
                    log(f"[kernels] {what}: max|err| forward "
                        f"{err['forward']:.3e}, backward {err['backward']:.3e}")
                    del a, x, g, h
                    continue
                for direction in ("forward", "backward"):
                    if direction == "forward":
                        def kernel():
                            return gated_linear_scan_cuda(a, x)

                        def plain():
                            return gated_linear_scan_plain(a, x)
                        # fp32 arithmetic on the carry whatever the storage
                        b_ms, b_by = bound(2.0 * n, 3.0 * n * esz, "float32")
                    else:
                        def kernel():
                            return gated_linear_scan_bwd_cuda(a, h, g)

                        def plain():
                            return gated_linear_scan_bwd_plain(a, h, g)
                        b_ms, b_by = bound(3.0 * n, 5.0 * n * esz, "float32")
                    times = _times(torch, kernel, None, None)
                    # a Python loop of T steps: timed as issued only (3 calls)
                    times["plain_ms"] = time_ms(torch, plain, warmup=1, iters=3)
                    row = dict(shape=shape_name, direction=direction,
                               dtype=dtype, R=R, T=T, C=C, decay=decay,
                               max_abs_err=err[direction], **times,
                               bound_ms=b_ms, bound_by=b_by)
                    rows.append(row)
                    log(_row_line(f"gated_linear_scan {direction} {dtype} "
                                  f"R={R} T={T} C={C} a {decay}", row,
                                  "library"))
                    if (dtype, direction, shape_name) == (
                            "float32", "forward", ZAMBA2_CARRY):
                        main = row
                del a, x, g, h
            torch.cuda.empty_cache()
    rec["gated_linear_scan"] = rows
    rec["gated_linear_scan_op_launches"] = launches
    return main


# ---------------------------------------------------------------------------
# phase 3b: kernel_check -- the launch predicates against real launches
# ---------------------------------------------------------------------------

# flash: B, S, T, Hq, Hkv, D, causal, window, q_offset, kv_valid_len; every
# case in both dtypes.  The table's paths (UViT-H's b=2 at D=128, a rank's
# smollm-360m microbatch of the lm ranks phase), each head dim built and
# three that are not, each side of Hq % Hkv and of the cache's valid
# length, a window of 1 and of 0 (every key masked: a warning, zeros)
KC_FLASH = (
    [(2, 258, 258, 20, 20, 128, False, None, 0, None),
     (1, 4096, 4096, 15, 5, 64, True, None, 0, None)]
    + [(2, 70, 70, 4, 2, D, True, None, 0, None)
       for D in (8, 16, 32, 48, 64, 80, 96, 112, 128, 224, 256)]
    + [(1, 64, 64, 6, 3, 64, True, None, 0, None),
       (1, 64, 64, 6, 4, 64, True, None, 0, None),
       (2, 1, 96, 4, 2, 64, True, None, 40, 41),
       (2, 1, 96, 4, 2, 64, True, None, 40, 96),
       (2, 1, 96, 4, 2, 64, True, None, 40, 97),
       (1, 64, 64, 2, 2, 64, True, 1, 0, None),
       (1, 64, 64, 2, 2, 64, True, 0, 0, None)])
# skip: M, D, N; every case in both dtypes.  UViT-H's and Hunyuan-DiT's
# train shapes, each side of the bf16 TMA rule and of a thin last row tile
KC_SKIP = [(516, 2560, 2560), (2048, 2048, 2048), (64, 24, 40),
           (64, 12, 8), (64, 16, 12), (64, 12, 7), (1, 8, 8), (128, 64, 64),
           (159, 64, 64), (160, 64, 64)]
# scan: R, T, C in each of the four dtype pairs, both directions: zamba2's
# chunk carry (the kernel table's path), a ragged small shape, rows of a
# byte length that is not a multiple of 16 (no TMA)
KC_SCAN = [(2, 32, 80 * 64 * 64), (2, 200, 520), (1, 65, 3)]


def _kc_run(torch, report, launch, plain, dtype: str, what: str,
            name: str) -> str:
    """Launch one case the way its predicate says: accepted -> the kernel
    runs and equals its plain version; refused -> the wrapper raises
    before any launch.  Returns "launched" or "refused"."""
    from repro_torch.kernels import LAUNCHES
    before = LAUNCHES[name]
    if report.ok:
        got = launch()
        torch.cuda.synchronize()
        if LAUNCHES[name] != before + 1:
            fail(f"kernel_check {what}: accepted, but the wrapper counted "
                 f"{LAUNCHES[name] - before} launches")
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        plain() if isinstance(got, tuple) else (plain(),)):
            check_close(torch, g, w, dtype, f"kernel_check {what}")
        return "launched"
    try:
        launch()
    except (ValueError, TypeError):
        pass
    else:
        fail(f"kernel_check {what}: refused ({report.errors()}), but the "
             "wrapper launched")
    if LAUNCHES[name] != before:
        fail(f"kernel_check {what}: refused, but the wrapper launched")
    return "refused"


def _misaligned(torch, x):
    """``x``'s values at a base 2 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    y = buf[1:1 + x.numel()].view(x.shape)
    y.copy_(x)
    return y


def kernel_check_phase(torch, rec) -> None:
    """``repro_torch.analysis.kernel_check`` held to the kernels: every
    case of ``KC_FLASH``, ``KC_SKIP`` and ``KC_SCAN`` (and, on each bf16
    TMA route, a base 2 bytes off and float16 inputs) that the predicate
    accepts launches and equals its plain version; every case it refuses
    raises before a launch; each route's predicted tiles and shared memory
    equal the kernel's own report (``bf16_config`` /
    ``scan_config``, blocks per SM aside), and the budget equals the
    card's opt-in shared memory a block."""
    from repro_torch.analysis import kernel_check as kc
    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ops import \
        bf16_config as flash_cfg
    from repro_torch.kernels.linear_scan import (gated_linear_scan_bwd_cuda,
                                                 gated_linear_scan_bwd_plain,
                                                 gated_linear_scan_cuda,
                                                 gated_linear_scan_plain,
                                                 scan_config)
    from repro_torch.kernels.skip_matmul import (skip_concat_matmul_cuda,
                                                 skip_concat_matmul_plain)
    from repro_torch.kernels.skip_matmul.ops import bf16_config as skip_cfg

    t0 = time.perf_counter()
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    if optin != kc.SMEM_OPTIN:
        fail(f"kernel_check: the card's opt-in shared memory a block is "
             f"{optin}, the predicates' budget {kc.SMEM_OPTIN}")

    def same(pred: dict, cuda: dict, what: str):
        got = {k: v for k, v in cuda.items() if k != "blocks_per_sm"}
        want = {k: v for k, v in pred.items() if k != "route"}
        if got != want:
            fail(f"kernel_check {what}: predicted tiling {want}, the "
                 f"kernel's {got}")
    for D in kc.WGMMA_HEAD_DIMS:
        same(kc.flash_tiling("bfloat16", D), flash_cfg(D),
             f"flash bf16 D={D}")
    same(kc.skip_tiling("bfloat16"), skip_cfg(), "skip bf16")
    for a in kc.DTYPES:
        for x in kc.DTYPES:
            for bwd in (False, True):
                same(kc.scan_tiling(a, x, bwd),
                     scan_config(getattr(torch, a), getattr(torch, x), bwd),
                     f"scan a={a} x={x} backward={bwd}")

    gen = torch.Generator(device="cuda").manual_seed(3)
    tally = {k: {"launched": 0, "refused": 0, "warned": 0}
             for k in ("flash_attention", "skip_concat_matmul",
                       "gated_linear_scan")}

    def count(name, verdict, report):
        tally[name][verdict] += 1
        tally[name]["warned"] += any(f.level == "warn"
                                     for f in report.findings)

    def rnd(*shape, dtype="float32"):
        return torch.randn(*shape, device="cuda", generator=gen).to(
            getattr(torch, dtype))

    name = "flash_attention"
    for B, S, T, Hq, Hkv, D, causal, window, q_off, valid in KC_FLASH:
        for dtype in kc.DTYPES:
            q, k, v = (rnd(B, S, Hq, D, dtype=dtype),
                       rnd(B, T, Hkv, D, dtype=dtype),
                       rnd(B, T, Hkv, D, dtype=dtype))
            args = (causal, window, q_off, valid)
            rep = kc.check_flash_attention(B, S, T, Hq, Hkv, D, dtype=dtype,
                                           q_offset=q_off,
                                           kv_valid_len=valid, window=window)
            what = (f"flash {dtype} B={B} S={S} T={T} Hq={Hq} Hkv={Hkv} D={D}"
                    f" causal={causal} window={window} q_offset={q_off} "
                    f"kv_valid_len={valid}")
            # the plain version masks what the kernel refuses differently:
            # only an accepted case reaches it
            count(name, _kc_run(
                torch, rep, lambda: flash_attention_cuda(q, k, v, *args),
                lambda: attention_plain(q, k, v, *args), dtype, what, name),
                rep)
    for D in (16, 64):        # a base 2 bytes off: SIMT takes it, TMA not
        q = _misaligned(torch, rnd(1, 64, 2, D, dtype="bfloat16"))
        rep = kc.check_flash_attention(1, 64, 64, 2, 2, D, dtype="bfloat16",
                                       bases_aligned=False)
        count(name, _kc_run(
            torch, rep, lambda: flash_attention_cuda(q, q, q),
            lambda: attention_plain(q, q, q), "bfloat16",
            f"flash bf16 D={D} misaligned", name), rep)
    h = rnd(1, 64, 2, 64, dtype="float16")
    rep = kc.check_flash_attention(1, 64, 64, 2, 2, 64, dtype="float16")
    count(name, _kc_run(torch, rep, lambda: flash_attention_cuda(h, h, h),
                        None, "float16", "flash float16", name), rep)

    name = "skip_concat_matmul"
    for M, D, N in KC_SKIP:
        for dtype in kc.DTYPES:
            h, s_, w = (rnd(M, D, dtype=dtype), rnd(M, D, dtype=dtype),
                        rnd(2 * D, N, dtype=dtype) / math.sqrt(D))
            rep = kc.check_skip_concat_matmul(M, D, N, dtype=dtype)
            count(name, _kc_run(
                torch, rep, lambda: skip_concat_matmul_cuda(h, s_, w),
                lambda: skip_concat_matmul_plain(h, s_, w), dtype,
                f"skip {dtype} M={M} D={D} N={N}", name), rep)
    for dtype in kc.DTYPES:
        h = _misaligned(torch, rnd(64, 64, dtype=dtype))
        w = rnd(128, 64, dtype=dtype) / 8
        rep = kc.check_skip_concat_matmul(64, 64, 64, dtype=dtype,
                                          bases_aligned=False)
        count(name, _kc_run(
            torch, rep, lambda: skip_concat_matmul_cuda(h, h, w),
            lambda: skip_concat_matmul_plain(h, h, w), dtype,
            f"skip {dtype} misaligned", name), rep)
    h = rnd(64, 64, dtype="float16")
    rep = kc.check_skip_concat_matmul(64, 64, 64, dtype="float16")
    count(name, _kc_run(
        torch, rep, lambda: skip_concat_matmul_cuda(h, h, torch.cat([h, h])),
        None, "float16", "skip float16", name), rep)

    name = "gated_linear_scan"
    for R, T, C in KC_SCAN:
        for da in kc.DTYPES:
            for dx in kc.DTYPES:
                a = torch.sigmoid(rnd(R, T, C)).to(getattr(torch, da))
                x = rnd(R, T, C, dtype=dx)
                rep = kc.check_gated_linear_scan(R, T, C, dtype_a=da,
                                                 dtype_x=dx)
                tol = "bfloat16" if "bfloat16" in (da, dx) else "float32"
                count(name, _kc_run(
                    torch, rep, lambda: gated_linear_scan_cuda(a, x),
                    lambda: gated_linear_scan_plain(a, x), tol,
                    f"scan a={da} x={dx} R={R} T={T} C={C}", name), rep)
                h = gated_linear_scan_plain(a, x)
                g = rnd(R, T, C, dtype=dx)
                rep = kc.check_gated_linear_scan(R, T, C, dtype_a=da,
                                                 dtype_x=dx, backward=True)
                count(name, _kc_run(
                    torch, rep, lambda: gated_linear_scan_bwd_cuda(a, h, g),
                    lambda: gated_linear_scan_bwd_plain(a, h, g), tol,
                    f"scan backward a={da} x={dx} R={R} T={T} C={C}", name),
                    rep)
    a = rnd(2, 64, 256, dtype="float16")
    rep = kc.check_gated_linear_scan(2, 64, 256, dtype_a="float16")
    count(name, _kc_run(torch, rep, lambda: gated_linear_scan_cuda(a, a),
                        None, "float16", "scan float16", name), rep)
    torch.cuda.empty_cache()
    rec["kernel_check"] = dict(smem_optin=optin, cases=tally,
                               seconds=time.perf_counter() - t0)
    for k, v in tally.items():
        log(f"[kernel_check] {k}: {v['launched']} accepted shapes launched "
            f"and equal to the plain version, {v['refused']} refused before "
            f"a launch, {v['warned']} with a warning")
    log(f"[kernel_check] tiles and shared memory of every route = the "
        f"kernels' reports; budget {optin} bytes a block = the card's "
        f"opt-in; {rec['kernel_check']['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# phase 4: pipeline parity, card vs CPU
# ---------------------------------------------------------------------------

def _parity_model(kind: str, B: int, M: int, **over):
    """(cfg, pipeline graph, dataset) of a small config of ``kind``, kernels
    on; ``over`` replaces config fields."""
    from repro_torch.data import SyntheticLatentDataset
    from repro_torch.models import diffusion as dm
    if kind == "uvit":
        kw = dict(img_size=8, in_ch=4, patch=2, d_model=64, n_layers=8,
                  n_heads=4, d_ff=128, n_classes=10)
        kw.update(over)
        cfg = dm.UViTConfig(kw.pop("name", "uvit-pp"), use_skip_kernel=True,
                            use_flash=True, **kw)
        return (cfg, dm.uvit_pipeline_graph(cfg, batch=B // M),
                SyntheticLatentDataset(img_size=8, channels=4))
    kw = dict(img_size=8, in_ch=4, patch=2, d_model=32, n_layers=8, n_heads=4,
              d_ff=64, ctx_dim=16, ctx_len=4)
    kw.update(over)
    cfg = dm.HunyuanDiTConfig(kw.pop("name", "hunyuan-pp"),
                              use_skip_kernel=True, use_flash=True, **kw)
    return (cfg, dm.hunyuan_pipeline_graph(cfg, batch=B // M),
            SyntheticLatentDataset(img_size=8, channels=4,
                                   text_dim=cfg.ctx_dim,
                                   text_len=cfg.ctx_len))


def _model_fns(cfg, kind: str):
    from repro_torch.runtime.adapters import model_fns
    return model_fns(cfg, kind)


def _pipeline_step(torch, cfg, graph, kind: str, D: int, M: int, params,
                   raw, t, noise, dev: str, wire_dtype: str, **plan_kw):
    """One step of the port's wave executor for ``cfg`` on ``dev`` from the
    merged fp32 ``params`` (cast to ``cfg.param_dtype``): the loss, every
    gradient as fp32 on the CPU by path, and the plan's first line.
    ``plan_kw`` goes to ``auto_pipeline``."""
    import numpy as np

    from repro_torch.runtime.adapters import make_diffusion_microbatches
    from repro_torch.runtime.compile import auto_pipeline
    from repro_torch.tree import tree_map, tree_paths

    cp = auto_pipeline(graph, _model_fns(cfg, kind), D,
                       pipeline_devices=D, microbatches=M,
                       wire_dtype=wire_dtype, **plan_kw)
    p = tree_map(lambda x: x.detach().to(dev, cfg.param_dtype).clone()
                 .requires_grad_(True), cp.split_params(params))
    batch = {k: torch.as_tensor(np.asarray(v), device=dev)
             for k, v in raw.items()}
    (enc, dec), edge = p
    mb, aux = make_diffusion_microbatches(
        batch, M, cfg, kind, t=t.to(dev), noise=noise.to(dev), params=edge)
    loss = cp.build()(enc, dec, edge, mb, aux)
    loss.backward()
    grads = cp.merge_params(*tree_map(
        lambda x: x.grad if x.grad is not None else torch.zeros_like(x), p))
    return (float(loss.detach().float()),
            {k: v.detach().float().cpu() for k, v in tree_paths(grads)},
            cp.describe().splitlines()[0])


def _parity_inputs(torch, cfg, kind, M, ds):
    """fp32 params on the CPU from seed 0, a batch, and (t, noise) from
    seed 1."""
    B = 2 * M
    params = _model_fns(cfg, kind).init_fn(
        torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    t = torch.rand((B,), generator=gen)
    noise = torch.randn((B, cfg.img_size, cfg.img_size, cfg.in_ch),
                        generator=gen)
    return params, ds.batch(0, 0, B), t, noise


def _check_launched(launched: dict, name: str) -> None:
    for k in ("skip_concat_matmul", "flash_attention"):
        if not launched[k]:
            fail(f"pipeline parity {name}: the card's run launched "
                 f"{launched}; both kernels of the path must run")


# (kind, D, M, config fields): uvit-pp, hunyuan-pp, and the supervisor
# drills' uvit-nano pipeline (D=2, M=4, global batch 8)
PARITY_CASES = (("uvit", 4, 8, {}), ("hunyuan", 2, 4, {}),
                ("hunyuan", 4, 4, {}),
                ("uvit", 2, 4, dict(name="uvit-nano", patch=4, d_model=32,
                                    n_heads=2, d_ff=64)))


def pipeline_parity(torch, rec, kind: str, D: int, M: int, **over) -> None:
    from repro_torch.launch import train as train_mod
    cfg, graph, ds = _parity_model(kind, 2 * M, M, **over)
    if cfg != train_mod._model_config(train_mod._parse_args(
            ["--arch", cfg.name, "--pipeline"])):
        fail(f"pipeline parity: {cfg} is not the trainer's {cfg.name}")
    params, raw, t, noise = _parity_inputs(torch, cfg, kind, M, ds)
    out = {}
    before = dict(_launches())
    for dev in ("cpu", "cuda"):
        out[dev] = _pipeline_step(torch, cfg, graph, kind, D, M, params, raw,
                                  t, noise, dev, "float32")
    launched = {k: _launches()[k] - before[k] for k in before}
    name = f"{cfg.name} D={D} M={M}"
    _check_launched(launched, name)
    lc, gc_, plan = out["cpu"]
    lg, gg, _ = out["cuda"]
    if not math.isclose(lg, lc, rel_tol=1e-3):
        fail(f"pipeline parity {name}: loss on the card {lg} vs CPU {lc}")
    worst = 0.0
    for k, want in gc_.items():
        got = gg[k]
        try:
            torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-5)
        except AssertionError as e:
            fail(f"pipeline parity {name}: grad {k} differs:\n{e}")
        worst = max(worst, float((got - want).abs().max()))
    rec.setdefault("pipeline_parity", {})[name] = dict(
        loss_cuda=lg, loss_cpu=lc, max_abs_grad_err=worst, grads=len(gg),
        launches=launched, plan=plan)
    log(f"[parity] {name} fp32 wire: loss card {lg:.7f} cpu {lc:.7f}; "
        f"{len(gg)} grads, max|err| {worst:.3e}; launches {launched}")


def pipeline_parity_bf16(torch, rec, D: int = 2, M: int = 4) -> None:
    """The wave executor in bf16 on the card, through the kernels' bf16
    routes (the skip matmul's wgmma kernel and flash attention's
    tensor-core route, head dim 128: self-attention over 16 tokens and
    cross-attention over 77 text tokens), against the same params in fp32
    on the CPU (plain versions).  A Hunyuan-DiT config of d_model 256, 2
    heads of 128, 4 blocks, 8x8 latents.  The loss is held at rtol 2e-2;
    each gradient at ||g_card - g_cpu|| / ||g_cpu|| <= 5e-2: bf16 params,
    activations and wire round at every op across the whole block stack
    and back, so an elementwise bound would measure bf16's own rounding,
    not the kernels.  A gradient that is zero on the CPU (time_mlp, the
    unread xattn.wk/wv) must be zero on the card."""
    over = dict(name="hunyuan-bf16", d_model=256, n_layers=4, n_heads=2,
                d_ff=1024, ctx_dim=128, ctx_len=77)
    cfg32, graph32, ds = _parity_model("hunyuan", 2 * M, M, **over)
    cfg16, graph16, _ = _parity_model("hunyuan", 2 * M, M,
                                      dtype=torch.bfloat16,
                                      param_dtype=torch.bfloat16, **over)
    params, raw, t, noise = _parity_inputs(torch, cfg32, "hunyuan", M, ds)
    lc, gc_, plan = _pipeline_step(torch, cfg32, graph32, "hunyuan", D, M,
                                   params, raw, t, noise, "cpu", "float32")
    before = dict(_launches())
    lg, gg, _ = _pipeline_step(torch, cfg16, graph16, "hunyuan", D, M,
                               params, raw, t, noise, "cuda", "bfloat16")
    torch.cuda.synchronize()
    launched = {k: _launches()[k] - before[k] for k in before}
    name = f"{cfg16.name} D={D} M={M}"
    _check_launched(launched, name)
    if not (math.isfinite(lg) and math.isclose(lg, lc, rel_tol=2e-2)):
        fail(f"pipeline parity {name}: bf16 loss on the card {lg} vs fp32 "
             f"CPU {lc} (rtol 2e-2)")
    worst, worst_k = rel_errs(torch, gg, gc_, 5e-2, f"pipeline parity {name}")
    rec.setdefault("pipeline_parity", {})[name] = dict(
        loss_cuda=lg, loss_cpu=lc, max_rel_grad_err=worst,
        worst_grad=worst_k, grads=len(gg), launches=launched, plan=plan)
    log(f"[parity] {name} bf16 on the card vs fp32 CPU: loss card {lg:.7f} "
        f"cpu {lc:.7f}; {len(gg)} grads, worst ||err||/||g|| {worst:.3e} "
        f"({worst_k}); launches {launched}")


# the linear executors' skip-free model: the 8 encoder blocks of a 16-layer
# UViT (no skip projection), its embedding reading t from the microbatch,
# on a hand-built graph whose costs cut it unevenly (D=2, M=4)
LINEAR_TIMES = (4, 2, 1, 1, 1, 1, 1, 1)


def _linear_model(torch):
    """(cfg, model fns, graph) of the linear parity model, flash on."""
    from repro_torch.core.graph import Block, BlockGraph
    from repro_torch.models import diffusion as dm
    from repro_torch.runtime.compile import PipelineModelFns
    cfg = dm.UViTConfig("linear-uvit", img_size=8, in_ch=4, patch=2,
                        d_model=64, n_layers=16, n_heads=4, d_ff=128,
                        n_classes=10, use_flash=True)
    fns = PipelineModelFns(
        init_fn=lambda gen, device: {
            k: v for k, v in dm.init_uvit(gen, cfg, device).items()
            if k != "dec_blocks"},
        embed_fn=lambda e, mb, aux: dm.uvit_embed(e, mb["xt"], mb["t"], mb,
                                                  cfg),
        loss_fn=lambda e, x, mb, aux: torch.mean(torch.square(
            dm.uvit_output(e, x, cfg).float() - mb["noise"].float())),
        split_blocks=lambda p: ((p["enc_blocks"],), {
            k: v for k, v in p.items() if k != "enc_blocks"}),
        merge_blocks=lambda st, e: {**e, "enc_blocks": st[0]},
        block_fn=lambda bp, x, aux: dm._apply_vit_block(bp, x, cfg),
        num_param_stacks=1)
    graph = BlockGraph(tuple(Block(f"b{i}", float(c), param_bytes=1 << 10,
                                   act_bytes=1 << 10)
                             for i, c in enumerate(LINEAR_TIMES)))
    return cfg, fns, graph


def linear_parity(torch, rec, D: int = 2, M: int = 4) -> None:
    """The linear (skip-free) executors, table and closed form, fp32 and
    fp32 wire, one step on the card against the same step on the CPU
    (plain versions): loss and grads at rtol 1e-3, flash attention
    launched on the card (no block projects a skip)."""
    import numpy as np

    from repro_torch.data import SyntheticLatentDataset
    from repro_torch.runtime.adapters import make_diffusion_microbatches
    from repro_torch.runtime.compile import auto_pipeline
    from repro_torch.tree import tree_map, tree_paths

    cfg, fns, graph = _linear_model(torch)
    params = fns.init_fn(torch.Generator().manual_seed(0), "cpu")
    B = 2 * M
    raw = SyntheticLatentDataset(img_size=8, channels=4).batch(0, 0, B)
    gen = torch.Generator().manual_seed(1)
    t, noise = torch.rand((B,), generator=gen), torch.randn(
        (B, 8, 8, 4), generator=gen)
    for executor in ("table", "closed_form"):
        cp = auto_pipeline(graph, fns, D, pipeline_devices=D,
                           microbatches=M, lam=0.0, wire_dtype="float32",
                           executor=executor)
        out = {}
        before = dict(_launches())
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda x: x.detach().to(dev).clone()
                         .requires_grad_(True), cp.split_params(params))
            batch = {k: torch.as_tensor(np.asarray(v), device=dev)
                     for k, v in raw.items()}
            mb, aux = make_diffusion_microbatches(
                batch, M, t=t.to(dev), noise=noise.to(dev))
            (stack,), edge = p
            loss = cp.build()(stack, edge, {**mb, "t": aux["t"]})
            loss.backward()
            grads = cp.merge_params(*tree_map(
                lambda x: x.grad if x.grad is not None
                else torch.zeros_like(x), p))
            out[dev] = (float(loss.detach()),
                        {k: v.detach().cpu() for k, v in tree_paths(grads)})
        launched = {k: _launches()[k] - before[k] for k in before}
        name = f"linear {executor} D={D} M={M} cuts {cp.partition.cuts}"
        if not launched["flash_attention"] or launched["skip_concat_matmul"]:
            fail(f"pipeline parity {name}: launches {launched}; flash must "
                 "run, the skip matmul must not (no skips)")
        (lc, gc_), (lg, gg) = out["cpu"], out["cuda"]
        if not math.isclose(lg, lc, rel_tol=1e-3):
            fail(f"pipeline parity {name}: loss on the card {lg} vs CPU {lc}")
        worst = 0.0
        for k, want in gc_.items():
            try:
                torch.testing.assert_close(gg[k], want, rtol=1e-3, atol=1e-5)
            except AssertionError as e:
                fail(f"pipeline parity {name}: grad {k} differs:\n{e}")
            worst = max(worst, float((gg[k] - want).abs().max()))
        rec.setdefault("pipeline_parity", {})[name] = dict(
            loss_cuda=lg, loss_cpu=lc, max_abs_grad_err=worst,
            grads=len(gg), launches=launched,
            plan=cp.describe().splitlines()[0])
        log(f"[parity] {name} fp32 wire: loss card {lg:.7f} cpu {lc:.7f}; "
            f"{len(gg)} grads, max|err| {worst:.3e}; launches {launched}")


def _launches() -> dict:
    from repro_torch.kernels import launch_counts
    return launch_counts()


# ---------------------------------------------------------------------------
# phase 4b: the UNet, card vs CPU
# ---------------------------------------------------------------------------

# a narrow SDv2 UNet whose single heads are exactly the full model's head
# dims: 112 at level 1 (16x16), 224 at level 2 (8x8) and in the middle
UNET_PARITY = dict(img_size=16, base_ch=56, ch_mults=(1, 2, 4),
                   attn_levels=(1, 2), n_heads=1, ctx_dim=64, ctx_len=77)


def _unet_step(torch, cfg, params, batch, t, noise, dev):
    """The UNet's loss and every gradient (fp32, on the CPU, by path; an
    unread leaf, the cross-attention's wk/wv, gets zeros) on ``dev``."""
    from repro_torch.models.diffusion import unet_loss
    from repro_torch.tree import tree_map, tree_paths
    p = tree_map(lambda x: x.detach().to(dev).clone().requires_grad_(True),
                 params)
    b = {k: v.to(dev) for k, v in batch.items()}
    loss = unet_loss(p, b, t.to(dev), noise.to(dev), cfg)
    loss.backward()
    return (float(loss.detach().float()),
            {k: (x.grad if x.grad is not None else torch.zeros_like(x))
             .detach().float().cpu() for k, x in tree_paths(p)})


def unet_parity(torch, rec) -> None:
    """``UNET_PARITY`` with flash attention on (head dims 112 and 224):
    fp32 on the card (the kernel, cuDNN's convs, TF32 off) against the
    same step on the CPU (plain versions): loss at rtol 1e-4, each gradient
    at rtol 1e-4 with atol 1e-4 x its largest entry (a conv weight's
    gradient sums over every pixel of the batch, so its entries near zero
    keep no relative precision in another summation order); then bf16
    params (norm leaves fp32, as ``init_unet`` makes them) and activations
    on the card, flash attention on its tensor-core route at both head
    dims, against the fp32 CPU step: loss at rtol 2e-2, the worst
    gradient's ||err|| / ||g|| reported.  Each card run must launch the
    kernel twice per attention block."""
    import numpy as np

    from repro_torch.data import SyntheticLatentDataset
    from repro_torch.models.diffusion import UNetConfig, init_unet
    from repro_torch.tree import tree_map, tree_paths
    B = 4
    cfg32 = UNetConfig("sdv2-parity", use_flash=True, **UNET_PARITY)
    cfg16 = UNetConfig("sdv2-parity-bf16", use_flash=True,
                       dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                       **UNET_PARITY)
    params = init_unet(torch.Generator().manual_seed(0), cfg32, "cpu")
    # one launch per attention (self and cross: each has its own wq)
    want_launches = sum(k.endswith("/wq") for k, _ in tree_paths(params))
    like16 = init_unet(torch.Generator().manual_seed(0), cfg16, "cpu")
    params16 = tree_map(lambda x, y: x.to(y.dtype), params, like16)
    del like16
    ds = SyntheticLatentDataset(img_size=16, channels=4,
                                text_dim=cfg32.ctx_dim,
                                text_len=cfg32.ctx_len)
    batch = {k: torch.as_tensor(np.asarray(v))
             for k, v in ds.batch(0, 0, B).items() if k != "labels"}
    gen = torch.Generator().manual_seed(1)
    t = torch.rand((B,), generator=gen)
    noise = torch.randn((B, 16, 16, 4), generator=gen)
    lc, gc_ = _unet_step(torch, cfg32, params, batch, t, noise, "cpu")
    out = {}
    for name, cfg, p in (("fp32", cfg32, params), ("bf16", cfg16, params16)):
        before = _launches()["flash_attention"]
        lg, gg = _unet_step(torch, cfg, p, batch, t, noise, "cuda")
        torch.cuda.synchronize()
        launched = _launches()["flash_attention"] - before
        if launched != want_launches:
            fail(f"unet parity {name}: {launched} flash launches, want "
                 f"{want_launches} (self and cross in every attention "
                 "block)")
        tol = 1e-4 if name == "fp32" else 2e-2
        if not (math.isfinite(lg) and math.isclose(lg, lc, rel_tol=tol)):
            fail(f"unet parity {name}: loss on the card {lg} vs fp32 CPU "
                 f"{lc} (rtol {tol})")
        worst, worst_k = 0.0, None
        for k, want in gc_.items():
            got = gg[k]
            if name == "fp32":
                try:
                    torch.testing.assert_close(
                        got, want, rtol=1e-4,
                        atol=1e-4 * float(want.abs().max()))
                except AssertionError as e:
                    fail(f"unet parity fp32: grad {k} differs:\n{e}")
            ref = float(want.norm())
            if ref == 0.0:
                if float(got.norm()) != 0.0:
                    fail(f"unet parity {name}: grad {k} is zero on the CPU "
                         "but not on the card")
                continue
            rel = float((got - want).norm()) / ref
            if rel > worst:
                worst, worst_k = rel, k
        out[name] = dict(loss_cuda=lg, loss_cpu=lc, launches=launched,
                         max_rel_grad_err=worst, worst_grad=worst_k,
                         grads=len(gg))
        log(f"[parity] {cfg.name} (heads 112/224) {name} on the card vs "
            f"fp32 CPU: loss card {lg:.7f} cpu {lc:.7f}; {len(gg)} grads, "
            f"worst ||err||/||g|| {worst:.3e} ({worst_k}); flash launches "
            f"{launched}")
    rec["unet_parity"] = out


# ---------------------------------------------------------------------------
# phase 5: plan -- measured block costs, the hybrid tuner, and UViT-H
# trained on the plan the tuner picks
# ---------------------------------------------------------------------------

PLAN_ARCHS = ("uvit-h", "hunyuan-dit")
PLAN_BATCH = 16          # global batch of the steps on the tuner's plan
PLAN_STEPS = 4
PLAN_M = 2               # the tuner's M at N=2 (M = P, P = 2)
PLAN_PROFILE = dict(warmup=2, iters=10)


def _plan_model(arch: str):
    """(cfg, kind, model fns) of ``arch`` as the trainer configures it:
    full width and depth, bf16, both kernels on."""
    from repro_torch.launch import train as train_mod
    from repro_torch.runtime.adapters import diffusion_model_fns
    args = train_mod._parse_args(["--arch", arch, "--pipeline"])
    cfg, kind = train_mod._model_config(args), train_mod._kind(args)
    return cfg, kind, diffusion_model_fns(cfg, kind)


def _graph(cfg, kind: str, fwd_times=None):
    """The pipeline graph at the microbatch the steps run (``PLAN_BATCH //
    PLAN_M`` samples, the batch the trainer builds its graph at), with the
    roofline's costs or measured ones."""
    from repro_torch.core.hw import H100_SXM
    from repro_torch.models.diffusion import (hunyuan_pipeline_graph,
                                              uvit_pipeline_graph)
    fn = hunyuan_pipeline_graph if kind == "hunyuan" else uvit_pipeline_graph
    return fn(cfg, batch=PLAN_BATCH // PLAN_M, fwd_times=fwd_times,
              hw=H100_SXM)


def measure_blocks(torch, cfg, kind: str, fns) -> list:
    """Seconds per forward call of each of the model's blocks, in graph
    order, by ``measure_block_times`` on the card at the graph's batch:
    random bf16 weights from seed 0, random activations (and for
    Hunyuan-DiT the 77 text tokens and the adaLN conditioning), no
    autograd."""
    from repro_torch.core.profiler import measure_block_times
    from repro_torch.models.diffusion import hunyuan_temb
    from repro_torch.tree import tree_map
    B = PLAN_BATCH // PLAN_M
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        params = fns.init_fn(gen, "cuda")
        (enc, dec), edge = fns.split_blocks(params)
        x = torch.randn(B, cfg.n_tokens, cfg.d_model, device="cuda",
                        generator=gen).to(cfg.dtype)
        skip = torch.randn(x.shape, device="cuda", generator=gen).to(
            cfg.dtype)
        aux = {}
        if kind == "hunyuan":
            t = torch.rand((B,), device="cuda", generator=gen)
            aux = {"ctx": torch.randn(B, cfg.ctx_len, cfg.ctx_dim,
                                      device="cuda", generator=gen).to(
                                          cfg.dtype),
                   "temb": hunyuan_temb(edge, t, cfg)}
        calls = ([(fns.enc_block_fn,
                   (tree_map(lambda a: a[r], enc), x, aux))
                  for r in range(cfg.half)]
                 + [(fns.dec_block_fn,
                     (tree_map(lambda a: a[r], dec), x, skip, aux))
                    for r in range(cfg.half)])
        times = measure_block_times([f for f, _ in calls],
                                    [a for _, a in calls], **PLAN_PROFILE)
        torch.cuda.synchronize()
    del params, enc, dec, edge, calls
    return times


def _choice_row(c) -> dict:
    return dict(P=c.P, G=c.G, b=c.b, V=c.V, M=c.M, zero_stage=c.zero_stage,
                t_sample=c.t_sample, t_sched=c.t_sched,
                peak_gb=c.peak_mem / 1e9,
                cuts=list(c.partition.cuts) if c.partition else None)


def _choice_text(c) -> str:
    return (f"P={c.P} G={c.G} b={c.b} V={c.V} M={c.M} "
            f"zero_stage={c.zero_stage}")


def plans_of(graph, what: str) -> dict:
    """The cuts at D=4, V=1 and the tuner's ranked choices at N=2 and 4
    (top five, the best with P > 1, the drops), printed and returned."""
    from repro_torch.core.hw import H100_SXM
    from repro_torch.core.partition import partition
    from repro_torch.core.tuner import tune
    out = {"cuts_D4": list(partition(graph, 4, hw=H100_SXM).cuts)}
    log(f"[plan] {what}: cuts at D=4 V=1 {out['cuts_D4']}")
    for N in (2, 4):
        drops: list = []
        choices = tune(graph, N, hw=H100_SXM, drops=drops)
        pipe = [c for c in choices if c.partition is not None and c.P > 1]
        out[f"N{N}"] = dict(top5=[_choice_row(c) for c in choices[:5]],
                            best_pipeline=_choice_row(pipe[0]) if pipe
                            else None, drops=drops, n=len(choices))
        for i, c in enumerate(choices[:5]):
            log(f"[plan] {what}: N={N} #{i} {_choice_text(c)} t/sample "
                f"{c.t_sample:.6e} s t_sched {c.t_sched:.6e} s peak "
                f"{c.peak_mem / 1e9:.3f} GB")
        if pipe:
            c = pipe[0]
            log(f"[plan] {what}: N={N} best with P>1 (#"
                f"{choices.index(c)}): {_choice_text(c)} t/sample "
                f"{c.t_sample:.6e} s peak {c.peak_mem / 1e9:.3f} GB cuts "
                f"{list(c.partition.cuts)}")
        log(f"[plan] {what}: N={N} drops {drops or 'none'}")
    return out


def check_n4(graph, fns, arch: str) -> dict:
    """``auto_pipeline(graph, fns, 4)`` plans the tuner's own choice (P=2
    with two data replicas, G=2, on both models), with ``dp_size`` its G,
    and certifies it."""
    from repro_torch.core.hw import H100_SXM
    from repro_torch.core.tuner import tune
    from repro_torch.runtime.compile import auto_pipeline
    keep = [c for c in tune(graph, 4, hw=H100_SXM) if c.partition is not None
            and c.P > 1]
    want = keep[0]
    cp = auto_pipeline(graph, fns, 4, hw=H100_SXM)
    cert = cp.certify(name=f"{arch}-N4")
    if _choice_text(cp.choice) != _choice_text(want) or not cert.ok \
            or cp.pcfg.dp_size != want.G:
        fail(f"plan {arch} N=4: choice {_choice_text(cp.choice)} dp "
             f"{cp.pcfg.dp_size} vs tuner {_choice_text(want)}; certificate "
             f"{cert.summary()}")
    log(f"[plan] {arch} measured N=4: planned the tuner's choice "
        f"{_choice_text(cp.choice)} (dp_size {cp.pcfg.dp_size}); "
        f"{cert.summary()}")
    return dict(choice=_choice_row(want), outcome="planned",
                certificate=cert.summary(), describe=cp.describe())


def train_on_plan(torch, arch: str, graph, fns) -> dict:
    """``auto_pipeline(graph, fns, 2)``: the tuner's plan, certified, then
    ``PLAN_STEPS`` steps of the model at full width on it through the
    trainer (``train.run(args, compiled=cp)``: global batch
    ``PLAN_BATCH``, the tuner's M, bf16 wire, both pipeline devices in
    this process on the one card): every loss finite, no step skipped, the
    peak device memory against twice the busiest device's Eq. 14
    prediction at the executed microbatch."""
    from repro_torch.core.comm_model import WIRE_BYTES
    from repro_torch.core.hw import H100_SXM
    from repro_torch.core.tuner import peak_memory, profile_partition
    from repro_torch.launch import train as train_mod
    from repro_torch.runtime.compile import auto_pipeline

    cp = auto_pipeline(graph, fns, 2, hw=H100_SXM)
    c = cp.choice
    cert = cp.certify(name=f"{arch}-tuner-N2")
    log(f"[plan] tuner's plan at N=2: {_choice_text(c)}; "
        + cp.describe().replace("\n", "\n[plan]   "))
    log(f"[plan] {cert.summary()}")
    if not cert.ok:
        fail(f"plan: the tuner's plan does not certify: {cert.summary()}")
    if c.G != 1 or cp.pcfg.num_microbatches != PLAN_M:
        fail(f"plan: the tuner's N=2 choice {_choice_text(c)} is not the "
             f"one-replica M={PLAN_M} plan the graph's batch was built for")
    # Eq. 14 for the busiest device at the executed microbatch: one
    # microbatch of the graph's batch is b = 1
    tabs = cp.step_tables()
    predicted = peak_memory(
        profile_partition(graph, cp.partition), c.P, 1, wave=True, V=c.V,
        windows=(tabs.W_down + tabs.W_up, tabs.W_turn, tabs.W_skip),
        wire_bytes=WIRE_BYTES[cp.pcfg.wire_dtype])
    args = train_mod._parse_args([
        "--arch", arch, "--pipeline", "--global-batch", str(PLAN_BATCH),
        "--steps", str(PLAN_STEPS), "--log-every", "1", "--device", "cuda"])
    res = train_mod.run(args, compiled=cp)
    losses = [res.losses[s] for s in sorted(res.losses)]
    if len(losses) != PLAN_STEPS or not all(math.isfinite(x)
                                            for x in losses):
        fail(f"plan: losses on the tuner's plan {losses}")
    if res.skipped_steps:
        fail(f"plan: {res.skipped_steps} non-finite updates skipped")
    step_s = [res.step_seconds[s] for s in sorted(res.step_seconds)]
    peak = res.peak_bytes
    del res
    return dict(choice=_choice_row(c), describe=cp.describe(),
                certificate=cert.to_dict(), losses=losses,
                step_seconds=step_s, predicted_device_bytes=predicted,
                predicted_card_bytes=2 * predicted, peak_bytes=peak,
                peak_over_prediction=peak / (2 * predicted))


def plan_phase(torch, rec) -> dict:
    """Phase 5: measure every block of UViT-H and Hunyuan-DiT-3B, print the
    plans on analytic and measured costs, check N=4 against the tuner's
    choice, and train UViT-H on the tuner's N=2 plan.  Returns the kernel
    launches of the phase (profiling and training)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    out: dict = {}
    reset_launch_counts()
    models = {}
    for arch in PLAN_ARCHS:
        cfg, kind, fns = _plan_model(arch)
        before = launch_counts()
        times = measure_blocks(torch, cfg, kind, fns)
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        calls = PLAN_PROFILE["warmup"] + PLAN_PROFILE["iters"]
        want = {"flash_attention": (2 if kind == "hunyuan" else 1)
                * 2 * cfg.half * calls,
                "skip_concat_matmul": cfg.half * calls}
        if any(launched[k] != v for k, v in want.items()):
            fail(f"plan {arch}: profiling launched {launched}, want {want} "
                 "(every block through flash, every decoder block through "
                 "the skip matmul)")
        analytic = _graph(cfg, kind)
        graph = _graph(cfg, kind, fwd_times=times)
        models[arch] = (cfg, kind, fns, graph)
        ana_ms = [b.fwd_time * 1e3 for b in analytic.blocks]
        ms = [t * 1e3 for t in times]
        ratio = [m / a for m, a in zip(ms, ana_ms)]
        log(f"[plan] {arch}: block forward ms at batch "
            f"{PLAN_BATCH // PLAN_M}, measured {[round(x, 4) for x in ms]}")
        log(f"[plan] {arch}: roofline ms {[round(x, 4) for x in ana_ms]}")
        log(f"[plan] {arch}: measured / roofline: enc mean "
            f"{sum(ratio[:cfg.half]) / cfg.half:.3f}, dec mean "
            f"{sum(ratio[cfg.half:]) / cfg.half:.3f}, min {min(ratio):.3f}"
            f", max {max(ratio):.3f}; sum {sum(ms):.4f} ms vs "
            f"{sum(ana_ms):.4f} ms; launches {launched}")
        out[arch] = dict(batch=PLAN_BATCH // PLAN_M, measured_ms=ms,
                         roofline_ms=ana_ms, launches=launched,
                         analytic=plans_of(analytic, f"{arch} roofline"),
                         measured=plans_of(graph, f"{arch} measured"))
        torch.cuda.empty_cache()
    for arch in PLAN_ARCHS:
        cfg, kind, fns, graph = models[arch]
        out[arch]["N4"] = check_n4(graph, fns, arch)
    _, _, fns, graph = models["uvit-h"]
    before = launch_counts()
    out["train"] = train_on_plan(torch, "uvit-h", graph, fns)
    counts = launch_counts()
    launched = {k: v - before[k] for k, v in counts.items()}
    if not (launched["flash_attention"] and launched["skip_concat_matmul"]):
        fail(f"plan: training on the tuner's plan launched {launched}; both "
             "kernels of the path must run")
    tr = out["train"]
    tr["launches"] = launched
    log(f"[plan] uvit-h on the tuner's plan: losses {tr['losses']}; step s "
        f"{[round(x, 4) for x in tr['step_seconds']]}; launches {launched}")
    log(f"[plan] peak device memory {tr['peak_bytes'] / 1e9:.3f} GB against "
        f"2 x {tr['predicted_device_bytes'] / 1e9:.3f} GB = "
        f"{tr['predicted_card_bytes'] / 1e9:.3f} GB predicted (Eq. 14, both "
        f"pipeline devices on one card): ratio "
        f"{tr['peak_over_prediction']:.3f}")
    out["launches"] = counts
    rec["plan"] = out
    return counts


# ---------------------------------------------------------------------------
# phases 6 and 8: train UViT-H, then Hunyuan-DiT-3B
# ---------------------------------------------------------------------------

def train(torch, rec, arch: str) -> dict:
    """``arch`` through ``repro_torch.launch.train``: the pipeline archs
    with ``TRAIN_ARGV`` (both model kernels must launch), the full UNet
    with ``UNET_ARGV`` (flash attention exactly ``UNET_FLASH_PER_STEP``
    times a step: every attention call through the kernel)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as train_mod
    from repro_torch.runtime import pipeline as rp

    unet = arch == "sdv2-unet-full"
    argv = UNET_ARGV if unet else ["--arch", arch] + TRAIN_ARGV
    args = train_mod._parse_args(argv)
    # UViT-H's record for the ranks phase: step 0's gradient fingerprints
    # before its update, and the ring bytes of the one-process walk
    fingerprints = {}

    def on_grads(step, grads):
        if step == 0:
            fingerprints.update(train_mod.grad_fingerprints(grads))

    reset_launch_counts()
    rp.reset_hop_bytes()
    t0 = time.perf_counter()
    res = train_mod.run(args, on_grads=on_grads if arch == "uvit-h" else None)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    hops = rp.hop_bytes()
    losses = [res.losses[s] for s in sorted(res.losses)]
    if len(losses) != args.steps or not all(math.isfinite(x) for x in losses):
        fail(f"train {arch}: losses {losses}")
    if res.skipped_steps:
        fail(f"train {arch}: {res.skipped_steps} non-finite updates skipped")
    if unet:
        if counts["flash_attention"] != UNET_FLASH_PER_STEP * args.steps:
            fail(f"train {arch}: kernel launch counts {counts}; want "
                 f"{UNET_FLASH_PER_STEP} flash launches a step")
    else:
        for k in ("skip_concat_matmul", "flash_attention"):
            if not counts[k]:
                fail(f"train {arch}: kernel launch counts {counts}; every "
                     "kernel of the path must run")
    steps = [res.step_seconds[s] for s in sorted(res.step_seconds)]
    steady = steps[1:] or steps
    sps = args.global_batch / (sum(steady) / len(steady))
    n_params = sum(x.numel() for x in _leaves(res.params))
    rec.setdefault("train", {})[arch] = dict(
        argv=argv, losses=losses, step_seconds=steps,
        samples_per_s_after_first=sps, peak_bytes=res.peak_bytes, wall_s=wall,
        launches=counts,
        launches_per_step={k: v / args.steps for k, v in counts.items()},
        params=n_params, plan=res.plan,
        hop_bytes_per_step={k: v / args.steps for k, v in hops.items()},
        fingerprints=fingerprints)
    log(f"[train] {arch}: {n_params} params; losses {losses}; step s "
        f"{[round(x, 4) for x in steps]}; {sps:.3f} samples/s after step "
        f"0; peak {res.peak_bytes / 1e9:.2f} GB; launches {counts} "
        f"({ {k: v / args.steps for k, v in counts.items()} } per step)")
    del res
    return counts


# ---------------------------------------------------------------------------
# phase 6b: baseline -- PULSE against the paper's skip-carry baseline, at
# UViT-H's full width and depth
# ---------------------------------------------------------------------------

BASELINE_D, BASELINE_M, BASELINE_B = 4, 8, 16     # the trainer's plan
BASELINE_TIMED = 3


def _skip_carry_merged(stacks, edge, D: int) -> dict:
    """The skip-carry layout's gradients merged back to the model's tree
    (encoder rows on devices < D/2, decoder rows on the rest)."""
    from repro_torch.tree import tree_map
    enc, dec = stacks
    return {**edge,
            "enc_blocks": tree_map(lambda x: x[:D // 2].flatten(0, 1), enc),
            "dec_blocks": tree_map(lambda x: x[D // 2:].flatten(0, 1), dec)}


def baseline_phase(torch, rec) -> dict:
    """UViT-H at full width and depth (bf16, random weights from seed 0)
    through three executors, one at a time, from the same params and the
    same microbatches (the trainer's plan: D=4, M=8, global batch 16):
    the table wave executor (fp32 wire), the same plan with
    ``executor="closed_form"``, and the paper's skip-carry baseline
    (``DiffusionPipelineAdapter.build_skip_carry_baseline``).  For each,
    one warm-up forward+backward and ``BASELINE_TIMED`` timed ones
    (synchronized, host clock): step ms, peak device memory, flash and skip
    launches a step, and the bytes each handed to its ring (dense: every
    payload a ppermute would move; live: what a receiver stores; forward
    only).  Beside them the analytic volumes of the PULSE and sequential
    partitions (``partition_comm_volume``).  Closed form vs table: loss at
    rtol 1e-3, each merged gradient at ||err||/||g|| <= 1e-2; skip-carry
    vs table: 2e-2 and 5e-2 (bf16).  Returns the phase's launches."""
    from repro_torch.core.comm_model import partition_comm_volume
    from repro_torch.core.hw import H100_SXM
    from repro_torch.core.partition import blockwise_partition
    from repro_torch.data import SyntheticLatentDataset
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as train_mod
    from repro_torch.models.diffusion import ddpm_draw, uvit_pipeline_graph
    from repro_torch.runtime import pipeline as rp
    from repro_torch.runtime.adapters import (DiffusionPipelineAdapter,
                                              make_diffusion_microbatches,
                                              model_fns)
    from repro_torch.runtime.compile import auto_pipeline
    from repro_torch.tree import tree_leaves, tree_map, tree_paths

    t_phase = time.perf_counter()
    D, M, B = BASELINE_D, BASELINE_M, BASELINE_B
    cfg = train_mod._model_config(train_mod._parse_args(
        ["--arch", "uvit-h", "--pipeline"]))
    fns = model_fns(cfg, "uvit")
    graph = uvit_pipeline_graph(cfg, batch=B // M, hw=H100_SXM)
    plan = dict(hw=H100_SXM, pipeline_devices=D, microbatches=M,
                wire_dtype="float32")
    cps = {"table": auto_pipeline(graph, fns, D, **plan),
           "closed_form": auto_pipeline(graph, fns, D,
                                        executor="closed_form", **plan)}
    ad = DiffusionPipelineAdapter(cfg, cps["table"].pcfg, "uvit")
    with torch.no_grad():
        params = fns.init_fn(torch.Generator(device="cuda").manual_seed(0),
                             "cuda")
    n_params = sum(x.numel() for x in tree_leaves(params))
    raw = SyntheticLatentDataset(img_size=cfg.img_size,
                                 channels=cfg.in_ch).batch(0, 0, B)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in raw.items()}
    t, noise = ddpm_draw(batch["latents"], 0)
    mb, aux = make_diffusion_microbatches(batch, M, cfg, "uvit", t=t,
                                          noise=noise)
    b = B // M
    act_elems = b * cfg.n_tokens * cfg.d_model        # one microbatch's
    # the payloads' dtype: the table executor's wire, the closed forms' the
    # model's own
    executors = {
        "table": (cps["table"].split_params, cps["table"].build,
                  cps["table"].merge_params, torch.float32),
        "closed_form": (cps["closed_form"].split_params,
                        cps["closed_form"].build,
                        cps["closed_form"].merge_params, cfg.dtype),
        "skip_carry": (ad.split_params_skip_carry,
                       ad.build_skip_carry_baseline,
                       lambda st, e: _skip_carry_merged(st, e, D), cfg.dtype)}
    out, ref, launched_all = {}, None, {}
    for name, (split, build, merge, payload_dtype) in executors.items():
        left = release(torch)
        p = tree_map(lambda x: x.detach().requires_grad_(True),
                     split(params))
        (enc, dec), edge = p
        fn = build()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launch_counts()
        rp.reset_hop_bytes()
        losses, secs = [], []
        for i in range(1 + BASELINE_TIMED):
            for x in tree_leaves(p):
                x.grad = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = fn(enc, dec, edge, mb, aux)
            loss.backward()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(loss.detach().float()))
            del loss
        steps = 1 + BASELINE_TIMED
        launched = launch_counts()
        hops = rp.hop_bytes()
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(x) for x in losses):
            fail(f"baseline {name}: losses {losses}")
        for k in ("skip_concat_matmul", "flash_attention"):
            if not launched[k]:
                fail(f"baseline {name}: launches {launched}; both kernels "
                     "of the path must run")
        grads = dict(tree_paths(merge(*tree_map(
            lambda x: x.grad if x.grad is not None else torch.zeros_like(x),
            p))))
        timed = sorted(x * 1e3 for x in secs[1:])
        unit = act_elems * payload_dtype.itemsize
        row = dict(
            loss=losses[-1], losses=losses, step_ms=timed[len(timed) // 2],
            step_ms_all=[x * 1e3 for x in secs],
            spread_ms=timed[-1] - timed[0],
            peak_bytes=peak, held_bytes_before=base, bytes_left_before=left,
            launches_per_step={k: v / steps for k, v in launched.items()},
            hop_bytes_per_step={k: v / steps for k, v in hops.items()},
            hop_activations_per_microbatch={
                k: v / steps / unit / M for k, v in hops.items()},
            payload_dtype=str(payload_dtype).removeprefix("torch."))
        if name == "table":
            ref = (losses[-1], grads)
        else:
            close_loss, bar = ((1e-3, 1e-2) if name == "closed_form"
                               else (2e-2, 5e-2))
            if not math.isclose(losses[-1], ref[0], rel_tol=close_loss):
                fail(f"baseline {name}: loss {losses[-1]} vs the table "
                     f"executor's {ref[0]} (rtol {close_loss})")
            row["worst_rel_grad_err"], row["worst_grad"] = rel_errs(
                torch, grads, ref[1], bar, f"baseline {name} vs table")
        out[name] = row
        for k, v in launched.items():
            launched_all[k] = launched_all.get(k, 0) + v
        log(f"[baseline] {name}: loss {losses[-1]:.6f}; step "
            f"{row['step_ms']:.1f} ms median of {BASELINE_TIMED} (spread "
            f"{row['spread_ms']:.1f}; warm-up {secs[0] * 1e3:.1f}); peak "
            f"{peak / 1e9:.2f} GB ({base / 1e9:.2f} held before); launches a "
            f"step {row['launches_per_step']}; hop bytes a step (forward; "
            f"the backward moves the same in reverse on a real ring) dense "
            f"{hops['dense'] / steps:.0f} live {hops['live'] / steps:.0f} = "
            f"{row['hop_activations_per_microbatch']['dense']:.3f} / "
            f"{row['hop_activations_per_microbatch']['live']:.3f} "
            f"{row['payload_dtype']} activations per microbatch"
            + (f"; ||err||/||g|| worst {row['worst_rel_grad_err']:.3e} "
               f"({row['worst_grad']})" if name != "table" else ""))
        del p, enc, dec, edge, fn, grads
    del ref, params
    act = graph.blocks[0].act_bytes
    pulse = partition_comm_volume(graph, cps["table"].partition)
    seq = partition_comm_volume(graph, blockwise_partition(graph, D))
    analytic = dict(pulse=pulse.fwd_total / act,
                    sequential=seq.fwd_total / act,
                    sequential_skip=seq.skip_bytes / act)
    analytic["reduction"] = 1 - analytic["pulse"] / analytic["sequential"]
    live = {k: out[k]["hop_activations_per_microbatch"]["live"]
            for k in ("closed_form", "skip_carry")}
    dense = {k: out[k]["hop_activations_per_microbatch"]["dense"]
             for k in ("closed_form", "skip_carry")}
    measured = dict(live=1 - live["closed_form"] / live["skip_carry"],
                    dense=1 - dense["closed_form"] / dense["skip_carry"])
    rec["baseline"] = dict(params=n_params, plan=cps["table"].describe(),
                           executors=out, analytic=analytic,
                           measured_reduction=measured, launches=launched_all,
                           wall_s=time.perf_counter() - t_phase)
    log(f"[baseline] UViT-H {n_params} params, D={D} M={M} b={b}; "
        f"analytic forward volume per microbatch (partition_comm_volume): "
        f"PULSE {analytic['pulse']:.3f} activations, sequential "
        f"{analytic['sequential']:.3f} ({analytic['sequential_skip']:.3f} of "
        f"them skips): {100 * analytic['reduction']:.1f} % less; the "
        f"executors' payloads, closed-form wave against skip-carry: "
        f"live {100 * measured['live']:.1f} % less, dense "
        f"{100 * measured['dense']:.1f} % less; phase "
        f"{rec['baseline']['wall_s']:.1f} s")
    return launched_all


# ---------------------------------------------------------------------------
# phase 7: checkpoint, exact and elastic resume of UViT-H (between the
# train phases 6 and 8)
# ---------------------------------------------------------------------------

CKPT_STOP, CKPT_END = 2, 4          # A saves step 2; B trains steps 2-3
# the checkpoint phase's UViT-H: full width, a quarter of its 32 blocks.
# Its state is hashed four times on one host core (write, a verify pass,
# B's and C's restores); the ``rank checkpoint`` phase saves and restores
# the full depth over four ranks.
CKPT_LAYERS = 8


def _host(tree):
    """A host copy of every leaf (a copy on the CPU too)."""
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x.detach().to("cpu", copy=True), tree)


def _bitwise_equal(torch, got: list, want: list, what: str) -> int:
    """Leaf by leaf, the same dtype, shape and bytes; returns the bytes
    compared."""
    if len(got) != len(want):
        fail(f"{what}: {len(got)} leaves, want {len(want)}")
    n = 0
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.detach().cpu()
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"{what}: leaf {i} is {g.dtype}{list(g.shape)}, want "
                 f"{w.dtype}{list(w.shape)}")
        gb = g.contiguous().view(-1).view(torch.uint8)
        wb = w.contiguous().view(-1).view(torch.uint8)
        if not torch.equal(gb, wb):
            fail(f"{what}: leaf {i} ({w.dtype}{list(w.shape)}) differs")
        n += gb.numel()
    return n


def checkpoint_phase(torch, rec, smi_line: str) -> dict:
    """UViT-H at full width and ``CKPT_LAYERS`` blocks through
    ``repro_torch.launch.train`` with ``TRAIN_ARGV`` plus a fresh
    ``--ckpt-dir`` under ``build/``:

    R. ``--ckpt-every 100 --faults stop@4``: the uninterrupted steps 0-3,
       no save, the reference of B's losses;
    A. ``--ckpt-every 2 --faults stop@2``: steps 0-1, an async save of step
       2 (host snapshot, then a background write of the verified
       checkpoint), stop;
    B. ``--resume --ckpt-every 2 --faults stop@4``: restores step 2 at the
       same plan, trains steps 2-3, saves step 4 beside step 2.  The
       restored state must equal A's state at the save bitwise, leaf by
       leaf on the host; the losses are held to R's steps 2-3 at rtol
       2e-2; GC at the save of step 4 meets two step directories and
       hashes neither (step 2 verified at the restore, step 4 written by
       this process); both model kernels must launch.  Step 4 is then
       removed;
    C. ``--devices 2 --resume --faults stop@3``: restores step 2 elastically
       (D=4 -> D=2); the restored params, merged to model space, must
       equal A's bitwise; one step with a finite loss.

    A degraded save, an unverifiable step or a missing launch fails the
    run.  Prints the checkpoint's bytes, the save's blocking (snapshot) and
    total seconds, its write rate, verify-and-restore seconds and the peak
    device memory of each restore, beside ``nvidia-smi``'s line.  The
    directory is removed at the end.  Returns the launch counts of B and
    C."""
    import dataclasses
    import shutil
    import tempfile
    import warnings

    from repro_torch.checkpoint import verify_step
    from repro_torch.configs import uvit_h
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as train_mod
    from repro_torch.tree import tree_flatten

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_",
                             dir=os.path.join(ROOT, "build"))
    out, counts = {}, {}

    def run(what, extra, devices="4", on_restore=None):
        argv = ["--arch", "uvit-h"] + TRAIN_ARGV + ["--ckpt-dir", ckdir] \
            + extra
        argv[argv.index("--devices") + 1] = devices
        left = release(torch)
        if left >= 1e9:
            fail(f"checkpoint {what}: {left / 1e9:.2f} GB still allocated "
                 "before the run; the previous one was not released")
        reset_launch_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = train_mod.run(train_mod._parse_args(argv),
                                on_restore=on_restore)
        counts[what] = launch_counts()
        for w in caught:
            if issubclass(w.category, RuntimeWarning):
                fail(f"checkpoint {what}: warned: {w.message}")
        losses = [res.losses[s] for s in sorted(res.losses)]
        if not all(math.isfinite(x) for x in losses) or res.skipped_steps:
            fail(f"checkpoint {what}: losses {res.losses}, "
                 f"{res.skipped_steps} skipped")
        out[what] = dict(argv=argv, losses=res.losses, start=res.start,
                         wall_s=time.perf_counter() - t0,
                         saves=res.saves, restore=res.restore,
                         peak_bytes=res.peak_bytes, launches=counts[what])
        return res

    def log_restore(what, r):
        log(f"[ckpt] {what}: verify-and-restore {r['total_s']:.2f} s "
            f"(verify + read + place {r['restore_s']:.2f} s, copy into the "
            f"live tensors {r['copy_s']:.2f} s), peak device memory "
            f"{r['peak_bytes'] / 1e9:.2f} GB")

    full = uvit_h.CFG       # the trainer reads it at each build
    uvit_h.CFG = dataclasses.replace(full, n_layers=CKPT_LAYERS)
    try:
        # R: the uninterrupted reference, no save
        res = run("R", ["--ckpt-every", "100", "--faults",
                        f"stop@{CKPT_END}"])
        base = [res.losses[s] for s in range(CKPT_END)]
        if os.listdir(ckdir):
            fail(f"checkpoint R: wrote {os.listdir(ckdir)}")
        nparams = sum(x.numel() for x in _leaves(res.logical_params))
        out["R"]["params"] = nparams
        del res

        # A: two steps, the save of step 2, stop
        res = run("A", ["--ckpt-every", "2", "--faults",
                        f"stop@{CKPT_STOP}"])
        if sorted(res.losses) != list(range(CKPT_STOP)):
            fail(f"checkpoint A: trained steps {sorted(res.losses)}")
        saves = res.saves
        if [s["step"] for s in saves] != [CKPT_STOP] or not saves[0]["path"]:
            fail(f"checkpoint A: saves {saves}")
        saved = _host({"params": res.params, "opt": res.opt_state})
        logical = res.logical_params
        del res
        save = saves[0]
        gb = save["bytes"] / 1e9
        t0 = time.perf_counter()
        leaves = verify_step(ckdir, CKPT_STOP)["num_leaves"]
        verify_s = time.perf_counter() - t0
        log(f"[ckpt] {smi_line}: uvit-h full width, {CKPT_LAYERS} of "
            f"{full.n_layers} blocks ({nparams} params), {leaves} "
            f"leaves, {save['bytes']} bytes; save: snapshot "
            f"{save['snapshot_s']:.2f} s (blocking), total "
            f"{save['total_s']:.2f} s (shard write {save['write_s']:.2f} s "
            f"= {gb / save['write_s']:.2f} GB/s, its hash "
            f"{save['hash_s']:.2f} s, GC {save['gc_s']:.2f} s); one verify "
            f"pass "
            f"{verify_s:.2f} s ({gb / verify_s:.2f} GB/s)")

        # B: exact resume at the same plan
        checked = {}

        def check_b(state, info):
            if info.elastic or info.step != CKPT_STOP:
                fail(f"checkpoint B: restored {info}")
            checked["bytes"] = _bitwise_equal(
                torch, tree_flatten(state)[0], tree_flatten(saved)[0],
                "checkpoint B: restored vs saved state")

        res = run("B", ["--resume", "--ckpt-every", str(CKPT_STOP),
                        "--faults", f"stop@{CKPT_END}"], on_restore=check_b)
        if not checked or res.start != CKPT_STOP or \
                sorted(res.losses) != list(range(CKPT_STOP, CKPT_END)):
            fail(f"checkpoint B: start {res.start}, steps "
                 f"{sorted(res.losses)}, checked {checked}")
        rel = max(abs(res.losses[s] - base[s]) / abs(base[s])
                  for s in range(CKPT_STOP, CKPT_END))
        if not rel <= 2e-2:
            fail(f"checkpoint B: losses {res.losses} vs the uninterrupted "
                 f"run's {base[CKPT_STOP:CKPT_END]} (largest relative "
                 f"difference {rel:.3e} > 2e-2)")
        out["B"].update(max_rel_loss_diff=rel, checked_bytes=checked["bytes"])
        # its save of step 4, beside step 2: GC hashes neither
        got = [(x["step"], bool(x["path"]), x["gc_hashed"])
               for x in res.saves]
        steps = sorted(os.listdir(ckdir))
        if got != [(CKPT_END, True, [])] or steps != [
                f"step_{CKPT_STOP:09d}", f"step_{CKPT_END:09d}"]:
            fail(f"checkpoint B: saves {res.saves}, step directories "
                 f"{steps}")
        gc2 = res.saves[0]
        shutil.rmtree(os.path.join(ckdir, f"step_{CKPT_END:09d}"))
        del res, saved
        log_restore("B same plan", out["B"]["restore"])
        log(f"[ckpt] B: restored state bitwise ({checked['bytes']} bytes), "
            f"losses {list(out['B']['losses'].values())} vs "
            f"{base[CKPT_STOP:CKPT_END]}, largest relative difference "
            f"{rel:.3e}; launches {counts['B']}; its save of step "
            f"{CKPT_END} beside step {CKPT_STOP}: snapshot "
            f"{gc2['snapshot_s']:.2f} s, npz {gc2['write_s']:.2f} s, "
            f"SHA-256 {gc2['hash_s']:.2f} s, GC {gc2['gc_s']:.4f} s over "
            f"two step directories, hashing none")

        # C: elastic resume onto D=2
        got = {}

        def check_c(state, info):
            if not info.elastic or info.step != CKPT_STOP:
                fail(f"checkpoint C: restored {info}")
            got["params"] = _host(state["params"])

        res = run("C", ["--resume", "--faults", f"stop@{CKPT_STOP + 1}"],
                  devices="2", on_restore=check_c)
        if "params" not in got or sorted(res.losses) != [CKPT_STOP]:
            fail(f"checkpoint C: steps {sorted(res.losses)}")
        merged = res.compiled.merge_params(*got["params"])
        out["C"]["checked_bytes"] = _bitwise_equal(
            torch, tree_flatten(merged)[0], tree_flatten(logical)[0],
            "checkpoint C: elastic logical params vs A's")
        out["C"]["plan"] = res.plan.splitlines()[0]
        del res, got, merged, logical
        log_restore("C elastic D=4->2", out["C"]["restore"])
        log(f"[ckpt] C: {out['C']['plan']}; logical params bitwise "
            f"({out['C']['checked_bytes']} bytes); loss "
            f"{out['C']['losses'][CKPT_STOP]:.4f}; launches {counts['C']}")
        release(torch)
    finally:
        uvit_h.CFG = full
        shutil.rmtree(ckdir, ignore_errors=True)
    for what in ("B", "C"):
        for k in ("skip_concat_matmul", "flash_attention"):
            if not counts[what][k]:
                fail(f"checkpoint {what}: kernel launch counts "
                     f"{counts[what]}; both model kernels must launch")
    rec["checkpoint"] = dict(runs=out, summary=dict(
        bytes=save["bytes"], leaves=leaves, snapshot_s=save["snapshot_s"],
        save_total_s=save["total_s"], write_s=save["write_s"],
        hash_s=save["hash_s"], gc_s=save["gc_s"], save_beside=gc2,
        write_GBps=gb / save["write_s"],
        verify_s=verify_s, verify_GBps=gb / verify_s,
        restore_B=out["B"]["restore"], restore_C=out["C"]["restore"],
        card=smi_line))
    return {"uvit-h resume": counts["B"], "uvit-h elastic": counts["C"]}


# ---------------------------------------------------------------------------
# phase 10: SkipViT on the wave pipeline, card vs CPU
# ---------------------------------------------------------------------------

SKIPVIT_ARGV = ["--arch", "skipvit", "--pipeline", "--devices", "2",
                "--microbatches", "4", "--global-batch", "8", "--steps", "3",
                "--wire-dtype", "float32", "--log-every", "100"]
# the JAX package's wave-asym differential: its block costs pull the fold's
# turnaround cut off-centre (D=2, M=4, lam 0)
WAVE_ASYM = dict(n_enc=3, n_mid=2, n_dec=3)
WAVE_ASYM_TIMES = [1, 1, 4, 0.5, 0.5, 0.5, 1, 1]


def _skipvit_launched(launched: dict, what: str) -> None:
    if not launched["flash_attention"] or launched["skip_concat_matmul"]:
        fail(f"{what}: the card's run launched {launched}; flash attention "
             "must run, the skip matmul must not (SkipViT's skip is "
             "additive)")


def skipvit_train(torch, rec) -> dict:
    """The trainer's entry point, ``--arch skipvit --pipeline`` at D=2, on
    the card (launch counts reset just before, read just after) and on the
    CPU from the same params (seed 0, made on the CPU) and draws: the
    losses at rtol 1e-3.  Returns the card's launches."""
    import numpy as np

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as train_mod
    from repro_torch.runtime.adapters import model_fns
    from repro_torch.tree import tree_map

    args = train_mod._parse_args(SKIPVIT_ARGV)
    cfg = train_mod._model_config(args)
    init = tree_map(lambda x: x.numpy(), model_fns(cfg, "skipvit").init_fn(
        torch.Generator().manual_seed(0), "cpu"))
    shape = (args.global_batch, cfg.img_size, cfg.img_size, cfg.in_ch)

    def draw(step):
        rng = np.random.default_rng(step)
        return (rng.random(shape[0], dtype=np.float32),
                rng.standard_normal(shape, dtype=np.float32))

    losses = {}
    for dev in ("cpu", "cuda"):
        a = train_mod._parse_args(SKIPVIT_ARGV + ["--device", dev])
        reset_launch_counts()
        res = train_mod.run(a, init_params=init, draw=draw)
        launched = launch_counts()
        losses[dev] = [res.losses[s] for s in sorted(res.losses)]
        plan = res.plan.splitlines()[0]
        del res
    what = "skipvit train"
    _skipvit_launched(launched, what)
    lc, lg = losses["cpu"], losses["cuda"]
    if len(lg) != args.steps or not all(
            math.isfinite(g) and math.isclose(g, c, rel_tol=1e-3)
            for g, c in zip(lg, lc)):
        fail(f"{what}: losses on the card {lg} vs CPU {lc} (rtol 1e-3)")
    worst = max(abs(g - c) / abs(c) for g, c in zip(lg, lc))
    rec.setdefault("skipvit_parity", {})["train"] = dict(
        argv=SKIPVIT_ARGV, losses_cuda=lg, losses_cpu=lc, max_rel_err=worst,
        launches=launched, plan=plan)
    log(f"[skipvit] train {' '.join(SKIPVIT_ARGV)}: {plan}; losses card "
        f"{lg} cpu {lc}; max rel err {worst:.3e}; launches {launched}")
    return launched


def skipvit_wave_asym(torch, rec) -> dict:
    """The SkipViT wave step on ``wave-asym`` on the card against the same
    step on the CPU, fp32, fp32 wire, at ``pipeline_parity``'s tolerance
    (loss rtol 1e-3, grads rtol 1e-3 atol 1e-5); its cuts must not be
    mirror-symmetric.  Returns the card's launches."""
    from repro_torch.data import SyntheticLatentDataset
    from repro_torch.models import diffusion as dm
    from repro_torch.runtime.compile import auto_pipeline
    name, D, M = "wave-asym", 2, 4
    cfg = dm.SkipViTConfig(name, use_flash=True, **WAVE_ASYM)
    graph = dm.skipvit_pipeline_graph(cfg, batch=2, fwd_times=WAVE_ASYM_TIMES)
    ds = SyntheticLatentDataset(img_size=8, channels=4)
    params, raw, t, noise = _parity_inputs(torch, cfg, "skipvit", M, ds)
    out = {}
    for dev in ("cpu", "cuda"):
        before = dict(_launches())
        out[dev] = _pipeline_step(torch, cfg, graph, "skipvit", D, M, params,
                                  raw, t, noise, dev, "float32", lam=0.0)
        torch.cuda.synchronize()
        launched = {k: _launches()[k] - before[k] for k in before}
    _skipvit_launched(launched, f"skipvit {name}")
    lc, gc_, plan = out["cpu"]
    lg, gg, _ = out["cuda"]
    part = auto_pipeline(graph, _model_fns(cfg, "skipvit"), D,
                         pipeline_devices=D, microbatches=M,
                         lam=0.0).partition
    if part.mirror_symmetric():
        fail(f"skipvit {name}: cuts {part.cuts} are symmetric")
    plan += f", cuts {part.cuts}"
    if not math.isclose(lg, lc, rel_tol=1e-3):
        fail(f"skipvit {name}: loss on the card {lg} vs CPU {lc}")
    worst = 0.0
    for k, want in gc_.items():
        try:
            torch.testing.assert_close(gg[k], want, rtol=1e-3, atol=1e-5)
        except AssertionError as e:
            fail(f"skipvit {name}: grad {k} differs:\n{e}")
        worst = max(worst, float((gg[k] - want).abs().max()))
    rec.setdefault("skipvit_parity", {})[name] = dict(
        loss_cuda=lg, loss_cpu=lc, max_abs_grad_err=worst, grads=len(gg),
        launches=launched, plan=plan)
    log(f"[skipvit] {name} D={D} M={M} fp32 wire: {plan}; loss card "
        f"{lg:.7f} cpu {lc:.7f}; {len(gg)} grads, max|err| {worst:.3e}; "
        f"launches {launched}")
    return launched


# ---------------------------------------------------------------------------
# phase 16: lm -- the decoder LMs: smollm-360m at full width (8 layers) on
# the folded and linear pipelines, qwen3-moe-30b-a3b at full width (2 of
# its 48 layers), and the seven smoke keys through the trainer
# ---------------------------------------------------------------------------

LM_SEQ = 4096            # the JAX train_4k shape's sequence
LM_BATCH = 16            # global batch of smollm's pipeline steps
LM_D, LM_M, LM_STEPS = 4, 8, 2   # two steps: the script's 1200 s
# smollm-360m at full width cut to 8 of its 32 layers in the lm and lm
# ranks phases, one a stage of the D=4 fold (the registry's cut): the
# sharded ranks phase's TP runs took the script past 1200 s on a slower
# host (1282.7 s), and these two phases' steps scale with the layers
LM_LAYERS = 8
LM_BAR = 1e-2            # bf16: a plan's first gradient norm vs lm_loss's
LM_TRAJ_BAR = 1e-4       # bf16: a plan's losses vs lm_loss + AdamW's, and
#                          the two plans' vs each other, every step
QWEN_LAYERS, QWEN_BATCH = 2, 2   # qwen3 cut to 2 of 48 layers to fit a card
LM_SMOKE_BATCH = 4
LM_SMOKE_BAR = 1e-5      # fp32: a smoke key's loss, card vs CPU


def _lm_smollm_cfg():
    """smollm-360m's config at full width, ``LM_LAYERS`` deep."""
    import dataclasses

    from repro_torch.configs.smollm_360m import CFG
    return dataclasses.replace(CFG, n_layers=LM_LAYERS)


def lm_digest(torch, params, tokens) -> dict:
    """What identifies smollm's seed-0 weights and batch: the sum of every
    weight (fp64) and of the tokens."""
    from repro_torch.tree import tree_leaves
    return dict(params=sum(float(x.double().sum())
                           for x in tree_leaves(params)),
                tokens=int(tokens.long().sum()))


def _lm_predicted_flash(cp) -> int:
    """Flash launches of one forward+backward of a plan, from its step
    tables: every stage task runs its blocks' attention once forward, and
    once more in the backward's recompute when the plan remats."""
    from repro_torch.runtime.schedule_exec import RUN_DEC, RUN_ENC
    tabs, lay = cp.step_tables(), cp.layout
    n = 0
    for d in range(tabs.sel.shape[0]):
        for t in range(tabs.sel.shape[1]):
            s, v = int(tabs.sel[d, t]), int(tabs.slot[d, t])
            if s == RUN_ENC:
                n += lay.enc_counts[d][v]
            elif s == RUN_DEC:
                n += lay.dec_counts[d][v]
    return n * (2 if cp.pcfg.remat else 1)


def lm_smollm(torch, rec) -> dict:
    """smollm-360m at full width, ``LM_LAYERS`` deep (bf16, seed-0 weights) at
    sequence ``LM_SEQ``, global batch ``LM_BATCH``, through ``auto_pipeline``
    at D=4, M=8 on the folded wave (``force_wave``; the tied embedding and
    readout on device 0) and the linear table plan, each from the same
    weights: ``LM_STEPS`` AdamW steps.  The reference: the whole model
    through the non-pipeline ``lm_loss`` (flash on) on the same weights
    and batch, a microbatch at a time into the same gradients, and the
    same AdamW steps.  Held: each plan's loss of every step against the
    reference's at ``LM_TRAJ_BAR`` relative, and against the other plan's
    at the same bar (so the steps after the first hold the gradients
    each plan applied); each plan's first gradient norm against the
    reference's at ``LM_BAR``; every loss finite; the flash launches of
    each step equal to the tables' count.  Returns the launches by
    plan."""
    CFG = _lm_smollm_cfg()
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import lm
    from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                                   global_norm)
    from repro_torch.runtime.adapters import lm_model_fns, make_lm_microbatches
    from repro_torch.runtime.compile import auto_pipeline
    from repro_torch.tree import tree_leaves, tree_map

    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        params = lm.init_lm(gen, CFG, "cuda")
    n_params = sum(x.numel() for x in tree_leaves(params))
    tokens = torch.randint(0, CFG.vocab, (LM_BATCH, LM_SEQ), generator=gen,
                           device="cuda", dtype=torch.int32)
    digest = lm_digest(torch, params, tokens)
    # the reference: the whole model's loss on the same weights and batch,
    # a microbatch at a time (equal sizes: the mean of the means is the
    # mean), its gradients summed in place, the same AdamW steps
    b = LM_BATCH // LM_M
    with torch.no_grad():
        ref_params = tree_map(torch.clone, params)
    for x in tree_leaves(ref_params):
        x.requires_grad_(True)
    ref_opt = adamw_init(ref_params)
    ref_losses, ref_norms, ref_secs = [], [], []
    for step in range(LM_STEPS):
        t0 = time.perf_counter()
        total = 0.0
        for i in range(0, LM_BATCH, b):
            loss = lm.lm_loss(ref_params, {"tokens": tokens[i:i + b]},
                              CFG) / LM_M
            loss.backward()
            total += float(loss.detach())
        grads = tree_map(lambda x: x.grad, ref_params)
        ref_norms.append(float(global_norm(grads)))
        adamw_update(ref_params, grads, ref_opt, AdamWConfig(lr=3e-4))
        for x in tree_leaves(ref_params):
            x.grad = None
        torch.cuda.synchronize()
        ref_secs.append(time.perf_counter() - t0)
        ref_losses.append(total)
        del grads, loss
    del ref_params, ref_opt
    release(torch)
    if not all(math.isfinite(x) for x in ref_losses + ref_norms):
        fail(f"lm smollm-360m: lm_loss + AdamW losses {ref_losses}, "
             f"gradient norms {ref_norms}")
    log(f"[lm] smollm-360m reference (lm_loss, no pipeline, {LM_M} "
        f"microbatches summed, AdamW): losses {ref_losses}; first gradient "
        f"norm {ref_norms[0]!r}; step s {[round(x, 3) for x in ref_secs]}")
    graph = lm.lm_pipeline_graph(CFG, batch=b, seq=LM_SEQ)
    mbs = make_lm_microbatches({"tokens": tokens}, LM_M)
    out, counts = {}, {}
    for plan, wave in (("wave", True), ("linear", None)):
        cp = auto_pipeline(graph, lm_model_fns(CFG), LM_D,
                           pipeline_devices=LM_D, microbatches=LM_M,
                           force_wave=wave)
        if cp.folded != bool(wave):
            fail(f"lm smollm {plan}: planned folded={cp.folded}")
        want = _lm_predicted_flash(cp)
        with torch.no_grad():
            stacks, edge = cp.split_params(tree_map(torch.clone, params))
        for x in tree_leaves((stacks, edge)):
            x.requires_grad_(True)
        opt = adamw_init((stacks, edge))
        fn = cp.build()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, secs, launched, norms = [], [], [], []
        reset_launch_counts()
        for step in range(LM_STEPS):
            before = launch_counts()["flash_attention"]
            t0 = time.perf_counter()
            loss = (fn(*stacks, edge, mbs, {}) if cp.folded
                    else fn(*stacks, edge, mbs))
            loss.backward()
            grads = tree_map(lambda x: x.grad, (stacks, edge))
            norms.append(float(global_norm(grads)))
            adamw_update((stacks, edge), grads, opt, AdamWConfig(lr=3e-4))
            for x in tree_leaves((stacks, edge)):
                x.grad = None
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(loss.detach()))
            launched.append(launch_counts()["flash_attention"] - before)
            del grads, loss
        counts[plan] = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        what = f"lm smollm-360m {plan}"
        if not all(math.isfinite(x) for x in losses):
            fail(f"{what}: losses {losses}")
        if any(n != want for n in launched):
            fail(f"{what}: flash launches a step {launched}, the tables "
                 f"predict {want}")
        rel = [abs(x - r) / abs(r) for x, r in zip(losses, ref_losses)]
        if not max(rel) <= LM_TRAJ_BAR:
            fail(f"{what}: losses {losses} vs the non-pipeline lm_loss + "
                 f"AdamW's {ref_losses} (relative {rel}, bar {LM_TRAJ_BAR})")
        norm_rel = abs(norms[0] - ref_norms[0]) / abs(ref_norms[0])
        if not norm_rel <= LM_BAR:
            fail(f"{what}: first gradient norm {norms[0]} vs the "
                 f"non-pipeline {ref_norms[0]} (relative {norm_rel:.3e} > "
                 f"{LM_BAR})")
        out[plan] = dict(cuts=list(cp.partition.cuts),
                         stages=cp.partition.num_stages,
                         makespan=cp.schedule.makespan, losses=losses,
                         step_seconds=secs, peak_bytes=peak,
                         flash_per_step=launched, flash_predicted=want,
                         loss_rel_err=rel, grad_norms=norms,
                         first_grad_norm_rel_err=norm_rel)
        log(f"[lm] {what}: D={LM_D} M={LM_M} S={cp.partition.num_stages} "
            f"cuts {list(cp.partition.cuts)}; losses {losses} (rel to the "
            f"reference {[f'{x:.2e}' for x in rel]}); first gradient norm "
            f"{norms[0]!r} (rel {norm_rel:.2e}); step s "
            f"{[round(s, 3) for s in secs]}; peak {peak / 1e9:.2f} GB; "
            f"flash {launched} a step, tables {want}")
        del stacks, edge, opt, fn, cp
        release(torch)
    between = [abs(a - b) / abs(b) for a, b in
               zip(out["wave"]["losses"], out["linear"]["losses"])]
    if not max(between) <= LM_TRAJ_BAR:
        fail(f"lm smollm-360m: the wave plan's losses "
             f"{out['wave']['losses']} vs the linear plan's "
             f"{out['linear']['losses']} (relative {between}, bar "
             f"{LM_TRAJ_BAR})")
    rec.setdefault("lm", {})["smollm-360m"] = dict(
        params=n_params, seq=LM_SEQ, global_batch=LM_BATCH, D=LM_D, M=LM_M,
        digest=digest,
        reference_losses=ref_losses, reference_grad_norms=ref_norms,
        reference_step_seconds=ref_secs, plans_rel_err=between, **out)
    log(f"[lm] smollm-360m: {n_params} params; both plans' losses within "
        f"{LM_TRAJ_BAR} of lm_loss + AdamW's and of each other (wave vs "
        f"linear {[f'{x:.2e}' for x in between]}) over {LM_STEPS} steps")
    return counts


def lm_qwen3(torch, rec) -> dict:
    """qwen3-moe-30b-a3b at full width, depth cut to ``QWEN_LAYERS`` of its
    48 layers so that params, grads and AdamW state fit one card (bf16,
    seed-0 weights): one non-pipeline value-and-grad of ``lm_loss`` at
    sequence ``LM_SEQ``, batch ``QWEN_BATCH`` (qk-norm, GQA 32:4 at head dim
    128 on flash's tensor-core route, 128-expert top-8 scatter dispatch),
    then one AdamW step and the loss again.  Held: finite losses and
    gradients; flash launched twice a layer in the value-and-grad (forward
    and the recompute of the config's ``remat``) and once a layer in the
    loss after.  Returns the launches."""
    import dataclasses

    from repro_torch.configs.qwen3_moe_30b_a3b import CFG
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(CFG, n_layers=QWEN_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        params = lm.init_lm(gen, cfg, "cuda")
    n_params = sum(x.numel() for x in tree_leaves(params))
    for x in tree_leaves(params):
        x.requires_grad_(True)
    opt = adamw_init(params)
    tokens = torch.randint(0, cfg.vocab, (QWEN_BATCH, LM_SEQ), generator=gen,
                           device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    loss = lm.lm_loss(params, {"tokens": tokens}, cfg)
    loss.backward()
    torch.cuda.synchronize()
    t_grad = time.perf_counter() - t0
    launched = launch_counts()
    grads = tree_map(lambda x: x.grad, params)
    finite = all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
    t0 = time.perf_counter()
    adamw_update(params, grads, opt, AdamWConfig(lr=3e-4))
    torch.cuda.synchronize()
    t_adam = time.perf_counter() - t0
    del grads
    for x in tree_leaves(params):
        x.grad = None
    with torch.no_grad():
        after = float(lm.lm_loss(params, {"tokens": tokens}, cfg))
    peak = torch.cuda.max_memory_allocated()
    what = f"lm qwen3-moe-30b-a3b ({QWEN_LAYERS} of 48 layers)"
    loss = float(loss.detach())
    if not (finite and math.isfinite(loss) and math.isfinite(after)):
        fail(f"{what}: loss {loss}, after AdamW {after}, grads finite "
             f"{finite}")
    want = (2 if cfg.remat else 1) * QWEN_LAYERS
    if launched["flash_attention"] != want \
            or launch_counts()["flash_attention"] != want + QWEN_LAYERS:
        fail(f"{what}: flash launches {launched['flash_attention']} in the "
             f"value-and-grad (want {want}), "
             f"{launch_counts()['flash_attention']} with the loss after "
             f"(want {want + QWEN_LAYERS})")
    rec.setdefault("lm", {})["qwen3-moe-30b-a3b"] = dict(
        layers=QWEN_LAYERS, params=n_params, seq=LM_SEQ, batch=QWEN_BATCH,
        loss=loss, loss_after_adamw=after, value_and_grad_s=t_grad,
        adamw_s=t_adam, peak_bytes=peak, launches=launched)
    log(f"[lm] {what}: depth cut from 48 to {QWEN_LAYERS} layers to fit one "
        f"card; {n_params} params; S={LM_SEQ} B={QWEN_BATCH}; loss "
        f"{loss!r}, after one AdamW step {after!r}; value-and-grad "
        f"{t_grad:.3f} s, AdamW {t_adam:.3f} s; peak {peak / 1e9:.2f} GB; "
        f"flash {launched['flash_attention']} in the value-and-grad "
        f"(2 a layer: forward, remat)")
    del params, opt
    return launch_counts()


def lm_smoke(torch, rec, factories=None, tag: str = "lm") -> dict:
    """Each smoke key of ``factories`` (default: the seven LM keys) through
    the trainer for one step (``--global-batch 4``) on the card and on the
    CPU from the same params (seed 0, made on the CPU) and batch (the
    trainer's own, drawn with numpy; whisper's frames, the loss's draw,
    made on the CPU and handed to both runs): the losses at rtol
    ``LM_SMOKE_BAR`` (fp32); on the card each kernel launched as often as
    ``smoke_launches`` says (flash once an attention call: the SIMT
    route, danube with its window, none for deepseek's MLA and xLSTM; the
    scan twice a Mamba2 block).  The kernel phase holds flash at each of
    these attention shapes (the ``lm smoke`` and ``recurrent smoke``
    rows).  Returns the card's launches."""
    from repro_torch.configs.smoke import LM_FACTORIES
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as train_mod
    from repro_torch.tree import tree_map

    total = dict.fromkeys(launch_counts(), 0)
    rows = {}
    for key, factory in (factories or LM_FACTORIES).items():
        _, init_fn, make_batch, cfg = factory(kernels=True)
        cpu_gen = torch.Generator().manual_seed(0)
        init = tree_map(lambda x: x.numpy(), init_fn(cpu_gen, "cpu"))
        proto = make_batch(cpu_gen, "cpu")
        draw = None
        if "frames" in proto:
            frames = torch.randn((LM_SMOKE_BATCH, *proto["frames"].shape[1:]),
                                 generator=cpu_gen).numpy()

            def draw(step):
                return (frames,)
        loss = {}
        for dev in ("cpu", "cuda"):
            args = train_mod._parse_args(
                ["--arch", key, "--steps", "1", "--global-batch",
                 str(LM_SMOKE_BATCH), "--log-every", "100", "--device", dev])
            reset_launch_counts()
            res = train_mod.run(args, init_params=init, draw=draw)
            launched = launch_counts()
            loss[dev] = res.losses[0]
            del res
        want = smoke_launches(cfg)
        if launched != want:
            fail(f"{tag} smoke {key}: launches {launched}; want {want}")
        if not (math.isfinite(loss["cuda"]) and math.isclose(
                loss["cuda"], loss["cpu"], rel_tol=LM_SMOKE_BAR)):
            fail(f"{tag} smoke {key}: loss on the card {loss['cuda']} vs "
                 f"CPU {loss['cpu']} (rtol {LM_SMOKE_BAR})")
        for k, v in launched.items():
            total[k] += v
        rows[key] = dict(loss_cuda=loss["cuda"], loss_cpu=loss["cpu"],
                         launches=launched)
        log(f"[{tag}] smoke {key} ({cfg.name}): one trainer step, loss card "
            f"{loss['cuda']!r} cpu {loss['cpu']!r}; launches {launched}")
    rec.setdefault(tag, {})["smoke"] = rows
    return total


def smoke_launches(cfg) -> dict:
    """The kernel launches of one trainer step of a smoke config on the
    card: flash once an attention call (forward only: its backward
    recomputes through the plain version), the scan once forward and once
    backward a Mamba2 block."""
    from repro_torch.kernels import launch_counts
    want = dict.fromkeys(launch_counts(), 0)
    if hasattr(cfg, "n_enc_layers"):          # whisper: self, self, cross
        want["flash_attention"] = cfg.n_enc_layers + 2 * cfg.n_dec_layers
    elif hasattr(cfg, "mamba"):               # Zamba2: + each shared site
        want["gated_linear_scan"] = 2 * cfg.n_layers
        want["flash_attention"] = len(cfg.shared_sites())
    elif getattr(cfg, "attn", None) is not None:
        want["flash_attention"] = cfg.n_layers
    return want


# ---------------------------------------------------------------------------
# phase 17: recurrent -- whisper-base, xlstm-125m and zamba2-2.7b at full
# width, the three smoke keys through the trainer
# ---------------------------------------------------------------------------

RECURRENT_SEQ = 4096          # the JAX train_4k shape: frames, or tokens
RECURRENT_STEPS = 3
WHISPER_BATCH = 8
WHISPER_FLASH_PER_STEP = 18   # 6 encoder self, 6 decoder self, 6 cross
WHISPER_DENSE_BAR = 1e-2      # bf16: the first loss vs use_flash=False's
XLSTM_BATCH = 2
# xlstm-125m cut to 6 of its 12 blocks (one sLSTM block, whose loop over
# the sequence is most of a step) in the recurrent and serve phases, to keep
# the script's time
XLSTM_LAYERS = 6
ZAMBA2_LAYERS, ZAMBA2_BATCH = 12, 2   # 12 of 54 Mamba2 blocks: 2 sites
MAMBA2_BAR = 1e-4             # fp32: the scan route vs the chunk loop


def _adamw_steps(torch, params, loss_fn, what: str) -> dict:
    """``RECURRENT_STEPS`` value-and-grads of ``loss_fn(params)`` and AdamW
    steps on the card: each step's loss, gradient norm, seconds (host
    clock around a synchronized step) and kernel launches, and the peak
    memory.  Fails on a loss or gradient norm that is not finite."""
    from repro_torch.kernels import launch_counts
    from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                                   global_norm)
    from repro_torch.tree import tree_leaves, tree_map

    for x in tree_leaves(params):
        x.requires_grad_(True)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = dict(losses=[], grad_norms=[], step_seconds=[], launches=[])
    for _ in range(RECURRENT_STEPS):
        before = launch_counts()
        t0 = time.perf_counter()
        loss = loss_fn(params)
        loss.backward()
        grads = tree_map(lambda x: x.grad, params)
        out["grad_norms"].append(float(global_norm(grads)))
        adamw_update(params, grads, opt, AdamWConfig(lr=3e-4))
        for x in tree_leaves(params):
            x.grad = None
        torch.cuda.synchronize()
        out["step_seconds"].append(time.perf_counter() - t0)
        out["losses"].append(float(loss.detach()))
        out["launches"].append({k: v - before[k]
                                for k, v in launch_counts().items()})
        del grads, loss
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in out["losses"] + out["grad_norms"]):
        fail(f"{what}: losses {out['losses']}, gradient norms "
             f"{out['grad_norms']}")
    del opt
    return out


def _steps_line(out: dict, smi_line: str) -> str:
    return (f"losses {out['losses']}; step s "
            f"{[round(x, 3) for x in out['step_seconds']]}; peak "
            f"{out['peak_bytes'] / 1e9:.2f} GB ({smi_line})")


def recurrent_whisper(torch, rec, smi_line: str) -> dict:
    """whisper-base at full width and depth (6+6 layers, d=512, 8 heads of
    64, bf16, seed-0 weights), frames 4096 and tokens 448 (the JAX
    ``batch_struct`` at ``train_4k``), batch ``WHISPER_BATCH``:
    ``RECURRENT_STEPS`` AdamW steps with flash on every attention.  Held:
    finite losses; flash ``WHISPER_FLASH_PER_STEP`` times a step (forward
    only) and no other kernel; the first loss within ``WHISPER_DENSE_BAR``
    of the same loss with the dense attention (``use_flash=False``) on the
    same weights and batch.  Returns the launches of the steps."""
    import dataclasses

    from repro_torch.configs.whisper_base import CFG, MAX_TGT
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import whisper as wh
    from repro_torch.tree import tree_leaves

    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        params = wh.init_whisper(gen, CFG, "cuda")
    n_params = sum(x.numel() for x in tree_leaves(params))
    batch = {"frames": torch.randn((WHISPER_BATCH, RECURRENT_SEQ,
                                    CFG.d_model), generator=gen,
                                   device="cuda"),
             "tokens": torch.randint(0, CFG.vocab, (WHISPER_BATCH, MAX_TGT),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32)}
    before = launch_counts()
    with torch.no_grad():
        dense = float(wh.whisper_loss(
            params, batch, dataclasses.replace(CFG, use_flash=False)))
    if launch_counts() != before:
        fail("recurrent whisper-base: the dense attention launched a kernel")
    release(torch)
    what = "recurrent whisper-base"
    reset_launch_counts()
    out = _adamw_steps(torch, params,
                       lambda p: wh.whisper_loss(p, batch, CFG), what)
    launched = launch_counts()
    want = dict.fromkeys(launched, 0)
    want["flash_attention"] = WHISPER_FLASH_PER_STEP
    if any(x != want for x in out["launches"]):
        fail(f"{what}: launches a step {out['launches']}, want {want}")
    rel = abs(out["losses"][0] - dense) / abs(dense)
    if not rel <= WHISPER_DENSE_BAR:
        fail(f"{what}: first loss {out['losses'][0]} vs the dense "
             f"attention's {dense} (relative {rel:.3e} > "
             f"{WHISPER_DENSE_BAR})")
    rec.setdefault("recurrent", {})["whisper-base"] = dict(
        params=n_params, frames=RECURRENT_SEQ, tokens=MAX_TGT,
        batch=WHISPER_BATCH, dense_loss=dense, first_loss_rel_err=rel, **out)
    log(f"[recurrent] whisper-base: {n_params} params; frames "
        f"{RECURRENT_SEQ} tokens {MAX_TGT} B={WHISPER_BATCH}; "
        + _steps_line(out, smi_line) + f"; first loss vs the dense "
        f"attention's {dense!r}: rel {rel:.2e}; flash "
        f"{out['launches'][0]['flash_attention']} a step")
    del params, batch
    return launched


def recurrent_xlstm(torch, rec, smi_line: str) -> dict:
    """xlstm-125m at full width (d=768, 4 heads; bf16, seed-0 weights) and
    ``XLSTM_LAYERS`` of its 12 blocks (one of them sLSTM) at sequence
    ``RECURRENT_SEQ``, batch ``XLSTM_BATCH`` (each mLSTM block's fp32 (B,
    S, S, H) tensors 0.54 GB): ``RECURRENT_STEPS`` AdamW steps; finite
    losses; no kernel on this path.  Returns the launches."""
    import dataclasses

    from repro_torch.configs.xlstm_125m import CFG
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import xlstm as xm
    from repro_torch.tree import tree_leaves

    CFG = dataclasses.replace(CFG, n_layers=XLSTM_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        params = xm.init_xlstm(gen, CFG, "cuda")
    n_params = sum(x.numel() for x in tree_leaves(params))
    tokens = torch.randint(0, CFG.vocab, (XLSTM_BATCH, RECURRENT_SEQ),
                           generator=gen, device="cuda", dtype=torch.int32)
    what = "recurrent xlstm-125m"
    reset_launch_counts()
    out = _adamw_steps(torch, params, lambda p: xm.xlstm_loss(
        p, {"tokens": tokens}, CFG), what)
    launched = launch_counts()
    if any(launched.values()):
        fail(f"{what}: launches {launched}; this path has no kernel")
    rec.setdefault("recurrent", {})["xlstm-125m"] = dict(
        params=n_params, seq=RECURRENT_SEQ, batch=XLSTM_BATCH, **out)
    log(f"[recurrent] xlstm-125m: {n_params} params; S={RECURRENT_SEQ} "
        f"B={XLSTM_BATCH}; " + _steps_line(out, smi_line))
    del params
    return launched


def mamba2_block_parity(torch, rec) -> None:
    """One full-width Mamba2 block of zamba2-2.7b (d=2560: 80 heads, N = P
    = 64, chunk 128) at sequence ``RECURRENT_SEQ``, batch
    ``ZAMBA2_BATCH``, fp32 (TF32 off), seed-0 weights: one value-and-grad
    through ``_ssd_chunked`` (the carry through the scan kernel) and
    through ``_ssd_chunked_plain`` (the JAX loop over chunks) on the same
    weights, input and cotangent.  Held: the output and every gradient
    leaf (the input's too) at rtol ``MAMBA2_BAR``, an entry near zero to
    1e-5 of its leaf's largest magnitude.  These launches compare the
    kernel with its plain version and count on no path."""
    from repro_torch.configs.zamba2_2_7b import CFG
    from repro_torch.models import mamba

    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        p = mamba.init_mamba2_block(gen, CFG.mamba, torch.float32, "cuda")
    x = torch.randn((ZAMBA2_BATCH, RECURRENT_SEQ, CFG.d_model),
                    generator=gen, device="cuda")
    g = torch.randn(x.shape, generator=gen, device="cuda")
    outs, secs = {}, {}
    for route, ssd in (("scan", mamba._ssd_chunked),
                       ("plain", mamba._ssd_chunked_plain)):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xi = x.clone().requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, _ = mamba.apply_mamba2_block(leaves, xi, CFG.mamba, ssd=ssd)
        y.backward(g)
        torch.cuda.synchronize()
        secs[route] = time.perf_counter() - t0
        outs[route] = {"y": y.detach(), "x": xi.grad,
                       **{k: v.grad for k, v in leaves.items()}}
        del leaves, xi, y
    errs = {}
    for k, want in outs["plain"].items():
        got = outs["scan"][k]
        atol = 1e-5 * float(want.abs().max())
        errs[k] = float((got - want).abs().max())
        try:
            torch.testing.assert_close(got, want, rtol=MAMBA2_BAR, atol=atol)
        except AssertionError as e:
            fail(f"mamba2 block {k}: the scan route disagrees with the plain "
                 f"chunk loop (rtol {MAMBA2_BAR}, atol {atol:.3e}):\n{e}")
    rec.setdefault("recurrent", {})["mamba2 block parity"] = dict(
        max_abs_err=errs, seconds=secs)
    log(f"[recurrent] mamba2 block (zamba2-2.7b width, S={RECURRENT_SEQ} "
        f"B={ZAMBA2_BATCH}, fp32): scan route vs chunk loop, max|err| "
        + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f"; value-and-grad s scan {secs['scan']:.3f}, loop "
        f"{secs['plain']:.3f}")
    del outs, p, x, g


def recurrent_zamba2(torch, rec, smi_line: str) -> dict:
    """zamba2-2.7b at full width (d=2560, Mamba2 80 heads x N 64 x P 64,
    shared attention 32 heads of 80 on flash; d_ff 10240), depth cut to
    ``ZAMBA2_LAYERS`` of its 54 Mamba2 blocks so that both shared blocks
    run (after blocks 5 and 11), bf16, seed-0 weights, sequence
    ``RECURRENT_SEQ``, batch ``ZAMBA2_BATCH``: ``RECURRENT_STEPS`` AdamW
    steps.  Held: finite losses; the scan launched twice a Mamba2 block a
    step (forward, backward), flash once a shared site (forward only),
    nothing else.  Returns the launches."""
    import dataclasses

    from repro_torch.configs.zamba2_2_7b import CFG
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import mamba
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(CFG, n_layers=ZAMBA2_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        params = mamba.init_zamba2(gen, cfg, "cuda")
    n_params = sum(x.numel() for x in tree_leaves(params))
    tokens = torch.randint(0, cfg.vocab, (ZAMBA2_BATCH, RECURRENT_SEQ),
                           generator=gen, device="cuda", dtype=torch.int32)
    what = f"recurrent zamba2-2.7b ({ZAMBA2_LAYERS} of 54 blocks)"
    reset_launch_counts()
    out = _adamw_steps(torch, params, lambda p: mamba.zamba2_loss(
        p, {"tokens": tokens}, cfg), what)
    launched = launch_counts()
    want = dict.fromkeys(launched, 0)
    want["gated_linear_scan"] = 2 * ZAMBA2_LAYERS
    want["flash_attention"] = len(cfg.shared_sites())
    if any(x != want for x in out["launches"]):
        fail(f"{what}: launches a step {out['launches']}, want {want}")
    rec.setdefault("recurrent", {})["zamba2-2.7b"] = dict(
        layers=ZAMBA2_LAYERS, sites=cfg.shared_sites(), params=n_params,
        seq=RECURRENT_SEQ, batch=ZAMBA2_BATCH, **out)
    log(f"[recurrent] {what}: shared sites {cfg.shared_sites()}; "
        f"{n_params} params; S={RECURRENT_SEQ} B={ZAMBA2_BATCH}; "
        + _steps_line(out, smi_line) + f"; scan "
        f"{out['launches'][0]['gated_linear_scan']}, flash "
        f"{out['launches'][0]['flash_attention']} a step")
    del params
    return launched


# ---------------------------------------------------------------------------
# phase 18: serve -- prefill and greedy decode through the KV caches and
# recurrent states: smollm-360m, whisper-base, xlstm-125m and zamba2-2.7b at
# full width and depth, then the smoke keys card vs CPU
# ---------------------------------------------------------------------------

SERVE_LM = dict(batch=16, prompt=2048, gen=64)       # smollm-360m
SERVE_WHISPER = dict(batch=8, frames=4096, prompt=64, gen=64)
SERVE_RECURRENT = dict(batch={"xlstm-125m": 4, "zamba2-2.7b": 2},
                       prompt=256, gen=32)
SERVE_SMOKE = dict(batch=4, prompt=8, gen=16)        # the JAX example's
SERVE_SMOKE_BAR = 1e-5    # fp32: a smoke key's logits, card vs CPU
# Each served model runs twice from the same seed-0 weights and prompts:
# in bf16 (the run timed and counted) and in fp32 (TF32 off).  The fp32
# run is the tight check of the caches and states: every step's logits
# against its fp32 reference within SERVE_FP32_BAR.  The bf16 run is held
# to its bf16 reference within SERVE_BF16_BAR, by model: FLASH_BF16_REL
# where bf16 rounding allows it; for smollm-360m's 32 random layers and
# zamba2's 54 blocks, rounding alone puts a bf16 run past 1e-2 from
# another bf16 run of the same function (on an H100: 1.991e-02 from the
# dense run, 5.871e-02 from the chunked forward, the references
# themselves 1.791e-02 and 6.940e-02 from fp32), so their bars sit about
# 1.5x over those readings.
SERVE_FP32_BAR = 1e-3
SERVE_BF16_BAR = {"smollm-360m": 3e-2, "whisper-base": FLASH_BF16_REL,
                  "xlstm-125m": FLASH_BF16_REL, "zamba2-2.7b": 8e-2}


def _rel(torch, got, want) -> float:
    """||got - want|| / ||want||, in fp32."""
    got, want = got.float(), want.float()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def _held(torch, what: str, got, want, bar: float = None) -> float:
    bar = FLASH_BF16_REL if bar is None else bar
    rel = _rel(torch, got, want)
    if not (torch.isfinite(got).all() and rel <= bar):
        fail(f"serve {what}: relative error {rel:.3e} > {bar}")
    return rel


def _fp32(torch, params, cfg, **over):
    """The same weights and config in fp32 (TF32 off), ``over`` replaced."""
    import dataclasses

    from repro_torch.tree import tree_map
    return (tree_map(lambda x: x.float(), params),
            dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32, **over))


def _tree_bytes(tree) -> int:
    """Bytes of a tree's tensor leaves (meta tensors included)."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree)
               if hasattr(t, "numel"))


def _serve_row(arch: str, B: int, gen: int, prefill_s: float,
               decode_s: float, steps: int, peak: int, launched: dict,
               want: dict, cache: int, cache_formula: int, smi_line: str,
               **held) -> dict:
    if launched != want:
        fail(f"serve {arch}: launches {launched}; want {want}")
    if cache != cache_formula:
        fail(f"serve {arch}: KV caches of {cache} bytes; want "
             f"{cache_formula}")
    row = dict(batch=B, gen=gen, prefill_s=prefill_s, decode_s=decode_s,
               decode_ms_per_token=1e3 * decode_s / max(steps, 1),
               tokens_per_s=B * gen / (prefill_s + decode_s),
               peak_bytes=peak, cache_bytes=cache,
               cache_bytes_formula=cache_formula, launches=launched, **held)
    log(f"[serve] {arch}: B={B} gen={gen}: prefill {prefill_s:.3f} s, decode "
        f"{row['decode_ms_per_token']:.2f} ms/token ({steps} steps), "
        f"{row['tokens_per_s']:.1f} tokens/s, peak {peak / 1e9:.2f} GB, "
        f"cache {cache} B (formula {cache_formula}), flash "
        f"{launched['flash_attention']} (want {want['flash_attention']}); "
        + "; ".join(f"{k} {v:.3e}" for k, v in held.items())
        + f" ({smi_line})")
    return row


def _lm_held(torch, tag: str, params, cfg, dense, prompts, out,
             bar: float) -> dict:
    """A served LM run ``out`` (``generate``'s, logits kept) held at
    ``bar``: every step's logits against a teacher-forced run of ``dense``
    (``use_flash=False``) on the same tokens, and the last step's against
    ``forward`` without a cache over the prompt and the generated tokens.
    Returns the worst step's and the last step's relative errors."""
    from repro_torch.models import lm

    P, G = prompts.shape[1], out.tokens.shape[1]
    logits, caches = lm.prefill(params, prompts, dense, P + G)
    worst = _held(torch, f"{tag} step 0 vs dense", out.logits[0], logits,
                  bar)
    for i in range(G - 1):
        logits, caches = lm.decode_step(params, out.tokens[:, i:i + 1],
                                        caches, dense)
        worst = max(worst, _held(torch, f"{tag} step {i + 1} vs dense",
                                 out.logits[i + 1], logits, bar))
    del caches, logits
    seq = torch.cat([prompts, out.tokens[:, :-1]], 1)
    h = lm.forward(params, seq, cfg)[0][:, -1:]
    last = _held(torch, f"{tag} last step vs forward", out.logits[-1],
                 lm.unembed(params, h, cfg), bar)
    return {f"{tag} steps_vs_dense_max": worst,
            f"{tag} last_vs_forward": last}


def serve_smollm(torch, rec, smi_line: str) -> dict:
    """smollm-360m at full width and depth (seed-0 weights): a batch of
    ``SERVE_LM`` prompts prefilled into KV caches of prompt + gen rows,
    then greedy decode through ``launch.serve.generate`` in bf16, launch
    counts reset just before and read just after: flash once a layer at
    the prefill and at each of the gen - 1 steps.  Held: the prefill's last
    logits against ``forward`` and ``unembed`` without a cache, at
    ``FLASH_BF16_REL``; by ``_lm_held`` at ``SERVE_BF16_BAR``; and the same
    weights served in fp32, by ``_lm_held`` at ``SERVE_FP32_BAR``."""
    import dataclasses

    from repro_torch.configs.smollm_360m import CFG
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm

    B, P, G = SERVE_LM["batch"], SERVE_LM["prompt"], SERVE_LM["gen"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        params = lm.init_lm(gen, CFG, "cuda")
    prompts = torch.randint(0, CFG.vocab, (B, P), generator=gen,
                            device="cuda", dtype=torch.int32)
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = generate(params, CFG, prompts, G, keep_logits=True)
    launched = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(launched, 0)
    want["flash_attention"] = CFG.n_layers * G
    a = CFG.attn
    caches = lm.init_caches(CFG, B, P + G)
    cache = _tree_bytes(caches)
    del caches
    dense = dataclasses.replace(a, use_flash=False)
    p32, c32 = _fp32(torch, params, CFG)
    with torch.inference_mode():
        h, _, _ = lm.forward(params, prompts, CFG)
        held = {"prefill_vs_forward": _held(
            torch, "smollm-360m prefill", out.logits[0],
            lm.unembed(params, h[:, -1:], CFG))}
        del h
        held.update(_lm_held(torch, "bf16", params, CFG,
                             dataclasses.replace(CFG, attn=dense), prompts,
                             out, SERVE_BF16_BAR["smollm-360m"]))
        release(torch)
        o32 = generate(p32, c32, prompts, G, keep_logits=True)
        held.update(_lm_held(torch, "fp32", p32, c32,
                             dataclasses.replace(c32, attn=dense), prompts,
                             o32, SERVE_FP32_BAR))
        # observed, not held: bf16 rounding's distance from fp32 at the
        # prefill, the one step both runs take on the same tokens
        held["bf16_prefill_vs_fp32"] = _rel(torch, out.logits[0],
                                            o32.logits[0])
        held["fp32_tokens_equal_bf16"] = float(
            (o32.tokens == out.tokens).float().mean())
        del p32, o32
    row = _serve_row("smollm-360m", B, G, out.prefill_s, out.decode_s,
                     out.steps, peak, launched, want, cache,
                     2 * CFG.n_layers * B * (P + G) * a.n_kv_heads
                     * a.head_dim * CFG.dtype.itemsize, smi_line, **held)
    rec.setdefault("serve", {})["smollm-360m"] = dict(prompt=P, **row)
    del params, out
    return launched


def serve_whisper(torch, rec, smi_line: str) -> dict:
    """whisper-base at full width and depth (seed-0 weights):
    ``SERVE_WHISPER``'s frames encoded and its prompt tokens prefilled into
    the decoder's KV caches (``whisper.prefill``), then greedy
    ``decode_step``s in bf16; flash on the encoder (once a layer), on the
    prefill (self and cross, each layer) and at every step (self over the
    cache, cross over the frames).  Held as smollm's, in bf16 and in fp32,
    the dense run (``use_flash=False``) the reference."""
    import dataclasses

    from repro_torch.configs.whisper_base import CFG, MAX_TGT
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import whisper as wh

    B, P, G = SERVE_WHISPER["batch"], SERVE_WHISPER["prompt"], \
        SERVE_WHISPER["gen"]
    max_len = P + G
    if max_len > MAX_TGT:
        fail(f"serve whisper-base: {max_len} decoder rows > {MAX_TGT}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        params = wh.init_whisper(gen, CFG, "cuda")
    frames = torch.randn((B, SERVE_WHISPER["frames"], CFG.d_model),
                         generator=gen, device="cuda")
    prompts = torch.randint(0, CFG.vocab, (B, P), generator=gen,
                            device="cuda", dtype=torch.int32)

    def run(params, cfg, forced=None):
        """Prefill and G - 1 steps: the greedy tokens, or ``forced``'s."""
        kept = []
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, enc, caches = wh.prefill(params, frames, prompts, cfg,
                                             max_len)
            tok = torch.argmax(logits, -1).to(torch.int32)
            kept.append(logits)
            toks = [tok]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for i in range(G - 1):
                if forced is not None:
                    tok = forced[:, i:i + 1]
                logits, caches = wh.decode_step(params, tok, enc, caches, cfg)
                tok = torch.argmax(logits, -1).to(torch.int32)
                kept.append(logits)
                toks.append(tok)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        return torch.cat(toks, 1), kept, enc, t1 - t0, t2 - t1

    def readout(p, cfg, tokens, enc):
        h, _ = wh.decode(p, tokens, enc, cfg)
        return h[:, -1:] @ p["tok_embed"].T.to(h.dtype)

    def held_at(tag, p, cfg, tokens, logits, enc, bar):
        """As ``_lm_held``: the steps against the teacher-forced dense run,
        the last against ``decode`` over prompt and generated tokens."""
        _, ref, _, _, _ = run(p, dataclasses.replace(cfg, use_flash=False),
                              forced=tokens)
        worst = max(_held(torch, f"whisper-base {tag} step {i} vs dense", g,
                          r, bar) for i, (g, r) in enumerate(zip(logits, ref)))
        seq = torch.cat([prompts, tokens[:, :-1]], 1)
        last = _held(torch, f"whisper-base {tag} last step", logits[-1],
                     readout(p, cfg, seq, enc), bar)
        return {f"{tag} steps_vs_dense_max": worst,
                f"{tag} last_vs_decode": last}

    release(torch)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    tokens, logits, enc, prefill_s, decode_s = run(params, CFG)
    launched = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    L = CFG.n_dec_layers
    want = dict.fromkeys(launched, 0)
    want["flash_attention"] = CFG.n_enc_layers + 2 * L + (G - 1) * 2 * L
    cache = _tree_bytes(wh.init_dec_caches(CFG, B, max_len))
    p32, c32 = _fp32(torch, params, CFG)
    with torch.inference_mode():
        held = {"prefill_vs_decode": _held(
            torch, "whisper-base prefill", logits[0],
            readout(params, CFG, prompts, enc))}
        held.update(held_at("bf16", params, CFG, tokens, logits, enc,
                            SERVE_BF16_BAR["whisper-base"]))
        t32, l32, enc32, _, _ = run(p32, c32)
        held.update(held_at("fp32", p32, c32, t32, l32, enc32,
                            SERVE_FP32_BAR))
        held["bf16_prefill_vs_fp32"] = _rel(torch, logits[0], l32[0])
        held["fp32_tokens_equal_bf16"] = float(
            (t32 == tokens).float().mean())
        del l32, enc32, p32
    row = _serve_row("whisper-base", B, G, prefill_s, decode_s, G - 1, peak,
                     launched, want, cache,
                     2 * L * B * max_len * CFG.n_heads * CFG.head_dim
                     * CFG.dtype.itemsize, smi_line, **held)
    rec.setdefault("serve", {})["whisper-base"] = dict(
        prompt=P, frames=SERVE_WHISPER["frames"], **row)
    del params, frames, enc, logits
    return launched


def serve_recurrent(torch, rec, arch: str, smi_line: str) -> dict:
    """xlstm-125m or zamba2-2.7b at full width (seed-0 weights), at the
    recurrent phase's depths (``XLSTM_LAYERS``, ``ZAMBA2_LAYERS``: its
    prompt steps were most of the serve phase's time),
    through ``launch.serve.generate`` in bf16: ``SERVE_RECURRENT``'s prompt
    stepped a token at a time (its first prompt_len - 1 tokens, as JAX
    ``serve.main``), then gen steps; launch counts reset just before and
    read just after: no kernel for xLSTM, flash once a shared site a step
    for Zamba2 (the SSM steps ``ssd_recurrent``, no scan).  Held: the bf16
    logits after the prompt's steps against ``forward`` over the prompt at
    ``SERVE_BF16_BAR`` (Zamba2's chunked SSD on the scan kernel, its 256
    tokens two chunks); and the same weights served in fp32, its first
    prompt_len steps (the prompt's and the first generated, fed the
    prompt's first token again) against ``forward`` over those prompt_len
    tokens at ``SERVE_FP32_BAR``."""
    import dataclasses

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import generate

    if arch == "xlstm-125m":
        from repro_torch.configs.xlstm_125m import CFG
        from repro_torch.models import xlstm as mod
        init = mod.init_xlstm
        CFG = dataclasses.replace(CFG, n_layers=XLSTM_LAYERS)
    else:
        from repro_torch.configs.zamba2_2_7b import CFG
        from repro_torch.models import mamba as mod
        init = mod.init_zamba2
        CFG = dataclasses.replace(CFG, n_layers=ZAMBA2_LAYERS)
    B, P, G = SERVE_RECURRENT["batch"][arch], SERVE_RECURRENT["prompt"], \
        SERVE_RECURRENT["gen"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        params = init(gen, CFG, "cuda")
    prompts = torch.randint(0, CFG.vocab, (B, P), generator=gen,
                            device="cuda", dtype=torch.int32)
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = generate(params, CFG, prompts, G, keep_logits=True)
    launched = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(launched, 0)
    sites = 0
    if arch == "zamba2-2.7b":
        sites = len(CFG.shared_sites())
        want["flash_attention"] = sites * (P - 1 + G)
        states = mod.init_states(CFG, B, P + G)
        a = CFG.shared_attn
        formula = (2 * sites * B * (P + G) * a.n_kv_heads * a.head_dim
                   * CFG.dtype.itemsize)
        cache = _tree_bytes(states["shared"])
    else:
        states = mod.init_states(CFG, B)
        formula = cache = 0
    state_bytes = _tree_bytes(states)
    del states

    def readout(p, cfg, tokens, rows=slice(None)):
        h, _ = mod.forward(p, tokens, cfg)
        return h[:, rows] @ p["embed"].T.to(h.dtype)
    p32, c32 = _fp32(torch, params, CFG)
    with torch.inference_mode():
        held = {"bf16 prompt_vs_forward": _held(
            torch, f"{arch} bf16 after the prompt", out.logits[P - 2],
            readout(params, CFG, prompts, slice(P - 2, P - 1)),
            SERVE_BF16_BAR[arch])}
        o32 = generate(p32, c32, prompts, G, keep_logits=True)
        fed = torch.cat([prompts[:, :P - 1], prompts[:, :1]], 1)
        ref = readout(p32, c32, fed)
        held["fp32 steps_vs_forward_max"] = max(
            _held(torch, f"{arch} fp32 step {i}", o32.logits[i],
                  ref[:, i:i + 1], SERVE_FP32_BAR) for i in range(P))
        held["bf16_after_prompt_vs_fp32"] = _rel(torch, out.logits[P - 2],
                                                 o32.logits[P - 2])
        held["fp32_tokens_equal_bf16"] = float(
            (o32.tokens == out.tokens).float().mean())
        del p32, o32, ref
    row = _serve_row(arch, B, G, out.prefill_s, out.decode_s, out.steps,
                     peak, launched, want, cache, formula, smi_line, **held)
    rec.setdefault("serve", {})[arch] = dict(
        prompt=P, prompt_steps=P - 1, state_bytes=state_bytes,
        shared_sites=sites, **row)
    log(f"[serve] {arch}: decode state {state_bytes} B in all")
    del params, out
    return launched


def serve_smoke(torch, rec) -> dict:
    """Every smoke key ``generate`` serves (the seven LMs, xLSTM, Zamba2;
    kernels on) from the same fp32 params (seed 0, made on the CPU) and
    prompts, ``SERVE_SMOKE`` batch, prompt and gen, on the card and on the
    CPU: the greedy tokens equal, every step's logits within
    ``SERVE_SMOKE_BAR`` relative; flash on the card once an attention call
    a step (none for deepseek's MLA and xLSTM).  Returns the card's
    launches."""
    from repro_torch.configs.smoke import LM_FACTORIES, RECURRENT_FACTORIES
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import generate
    from repro_torch.tree import tree_map

    B, P, G = SERVE_SMOKE["batch"], SERVE_SMOKE["prompt"], SERVE_SMOKE["gen"]
    keys = {**LM_FACTORIES, **{k: v for k, v in RECURRENT_FACTORIES.items()
                               if k != "whisper-base"}}
    total = dict.fromkeys(launch_counts(), 0)
    rows = {}
    for key, factory in keys.items():
        _, init_fn, _, cfg = factory(kernels=True)
        cpu_gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            params = init_fn(cpu_gen, "cpu")
        prompts = torch.randint(0, 256, (B, P), generator=cpu_gen,
                                dtype=torch.int32)
        want_out = generate(params, cfg, prompts, G, keep_logits=True)
        reset_launch_counts()
        got = generate(tree_map(lambda x: x.cuda(), params), cfg,
                       prompts.cuda(), G, keep_logits=True)
        launched = launch_counts()
        if not torch.equal(got.tokens.cpu(), want_out.tokens):
            fail(f"serve smoke {key}: tokens on the card "
                 f"{got.tokens.cpu().tolist()} vs the CPU's "
                 f"{want_out.tokens.tolist()}")
        worst = max(_held(torch, f"smoke {key} step {i}", g.cpu(), w,
                          SERVE_SMOKE_BAR)
                    for i, (g, w) in enumerate(zip(got.logits,
                                                   want_out.logits)))
        want = dict.fromkeys(launched, 0)
        if getattr(cfg, "attn", None) is not None:
            want["flash_attention"] = cfg.n_layers * G
        elif hasattr(cfg, "mamba"):
            want["flash_attention"] = len(cfg.shared_sites()) * (P - 1 + G)
        if launched != want:
            fail(f"serve smoke {key}: launches {launched}; want {want}")
        for k, v in launched.items():
            total[k] += v
        rows[key] = dict(logits_rel_err_max=worst, launches=launched,
                         sample=got.tokens[0].tolist())
        log(f"[serve] smoke {key} ({cfg.name}): B={B} prompt {P} gen {G}: "
            f"tokens equal card vs CPU, logits rel err max {worst:.2e}; "
            f"launches {launched}")
    rec.setdefault("serve", {})["smoke"] = rows
    return total


# ---------------------------------------------------------------------------
# phase 19: registry -- every bundle through get_arch; smollm-360m and
# internlm2-20b on their own train_4k plans through build_pp_train_step,
# qwen3-moe-30b-a3b with int8 AdamW moments, a smollm-360m serve step
# ---------------------------------------------------------------------------

REG_SEQ, REG_BATCH = 4096, 16   # the lm phase's sequence and global batch
REG_D, REG_STEPS = 4, 2         # the lm phase's D; the plans' M (16) stays
REG_MESH = {"data": 1, "model": REG_D}   # D pipeline devices, one process
REG_ONE = {"data": 1, "model": 1}
REG_REF_CHUNK = 2        # the references' microbatch (the lm phase's b)
REG_LOSS_BAR = 1e-4      # bf16: step 0's loss against the reference's
REG_BAR = 1e-2           # bf16: first gradient norm, the second loss
INTERNLM_LAYERS = 4      # of 48, at full width: about 2.7e9 params
REG_SMOLLM_LAYERS = 8    # of 32: one a stage of the D=4 fold (S = 8)
QWEN_FP32_PEAK_GB = 43.91   # the lm phase's fp32-AdamW peak (H100, 700 W)
REG_SERVE_STEPS = 8      # serve steps after the prefill (serve's B, prompt)


def _chunked(loss_fn, chunk: int):
    """``loss_fn`` over a batch as the mean of its losses over equal
    chunks of ``chunk`` rows (the mean of equal means is the mean): the
    references' batch of 16 at S=4096 in one piece would hold 16 GB of
    fp32 scores in flash's plain backward."""
    def loss(params, batch, rng=None):
        tok = batch["tokens"]
        n = tok.shape[0] // chunk
        return sum(loss_fn(params, {"tokens": tok[i * chunk:(i + 1) * chunk]})
                   for i in range(n)) / n
    return loss


def registry_bundles(torch, rec) -> None:
    """``get_arch`` of every name ``list_archs`` gives: every supported
    shape's ``batch_struct`` (also under a ``pp_*`` plan's microbatches for
    a train shape) and ``cache_struct`` built on the meta device, their
    bytes printed beside the bundle's param counts."""
    from repro_torch.configs import get_arch, list_archs
    from repro_torch.configs.base import SHAPES
    from repro_torch.train.steps import ParallelPlan
    from repro_torch.tree import tree_leaves

    pp = ParallelPlan(strategy="pp_1f1b", microbatches=16)
    rows = {}
    for name in list_archs():
        b = get_arch(name)
        shapes = {}
        for s, spec in SHAPES.items():
            if not b.supported(s):
                continue
            structs = {"batch": b.batch_struct(spec)}
            if spec.kind == "train":
                structs["batch pp"] = b.batch_struct(spec, pp)
            if b.cache_struct is not None:
                structs["cache"] = b.cache_struct(spec)
            for k, v in structs.items():
                if not all(x.is_meta for x in tree_leaves(v)
                           if isinstance(x, torch.Tensor)):
                    fail(f"registry {name} {s} {k}: a tensor off the meta "
                         "device")
            shapes[s] = {k: _tree_bytes(v) for k, v in structs.items()}
        rows[name] = dict(family=b.family, params=b.param_count,
                          active_params=b.active_param_count,
                          plans=sorted(b.plans), shapes=shapes)
        log(f"[registry] {name} ({b.family}): {b.param_count} params, "
            f"{b.active_param_count} active; plans {sorted(b.plans)}; "
            f"bytes by shape {shapes}")
    rec.setdefault("registry", {})["bundles"] = rows


def _reg_params(torch, bundle, gen):
    with torch.no_grad():
        return bundle.init_fn(gen, "cuda")


def registry_smollm(torch, rec, smi_line: str) -> dict:
    """smollm-360m from ``get_arch`` at full width, ``scaled_cfg`` to
    ``REG_SMOLLM_LAYERS`` of its 32 layers (bf16, seed-0 weights; the
    ``lm`` and ``lm ranks`` phases run all 32) on its own ``train_4k`` plan (``pp_wave``, M=16) through
    ``make_adapter`` with ``REG_MESH`` (the folded closed-form wave at
    D=4) and ``build_pp_train_step``: ``REG_STEPS`` AdamW steps at S=4096,
    global batch 16 (microbatches of 1).  The reference:
    ``build_sharded_train_step`` over the bundle's ``loss_fn`` (a chunk of
    ``REG_REF_CHUNK`` rows at a time) on the same weights and batch, the
    same steps.  Held: step 0's loss within ``REG_LOSS_BAR``, the first
    gradient norm and the second loss within ``REG_BAR``; every loss
    finite; flash launches of each step = layers x microbatches x 2
    (forward and the stage remat's recompute), the reference's layers x
    chunks x 2 (the config's per-layer remat).  Returns the launches by
    run."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec, meta
    from repro_torch.configs.lm_common import lm_bundle
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.optim import adamw_init, global_norm
    from repro_torch.train.steps import (build_pp_train_step,
                                         build_sharded_train_step)
    from repro_torch.tree import tree_map

    full = get_arch("smollm-360m")
    b = lm_bundle(full.name, full.scaled_cfg(REG_SMOLLM_LAYERS), full.plans)
    cfg, plan = b.cfg, b.plans["train_4k"]
    M = plan.microbatches
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = _reg_params(torch, b, gen)
    tokens = torch.randint(0, cfg.vocab, (REG_BATCH, REG_SEQ), generator=gen,
                           device="cuda", dtype=torch.int32)
    shape = ShapeSpec("registry", "train", REG_SEQ, REG_BATCH)
    runs, counts = {}, {}

    def run(what, step, p, o, batch, flash_want):
        norms, losses, secs, flash = [], [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        for _ in range(REG_STEPS):
            before = launch_counts()["flash_attention"]
            t0 = time.perf_counter()
            p, o, loss = step(p, o, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(loss))
            flash.append(launch_counts()["flash_attention"] - before)
        counts[what] = launch_counts()
        out = dict(losses=losses, step_seconds=secs, flash_per_step=flash,
                   flash_predicted=flash_want, grad_norms=norms_of[what],
                   peak_bytes=torch.cuda.max_memory_allocated())
        if not all(math.isfinite(x) for x in losses + out["grad_norms"]):
            fail(f"registry smollm-360m {what}: losses {losses}, gradient "
                 f"norms {out['grad_norms']}")
        if any(n != flash_want for n in flash):
            fail(f"registry smollm-360m {what}: flash {flash} a step, "
                 f"want {flash_want}")
        log(f"[registry] smollm-360m {what}: losses {losses}; first "
            f"gradient norm {out['grad_norms'][0]!r}; step s "
            f"{[round(x, 3) for x in secs]}; peak "
            f"{out['peak_bytes'] / 1e9:.2f} GB; flash {flash} a step, want "
            f"{flash_want} ({smi_line})")
        runs[what] = out

    norms_of = {"reference": [], "pp_wave": []}
    # the reference: the whole model, the bundle's loss_fn, AdamW
    ref_plan = dataclasses.replace(plan, strategy="sharded")
    step, _ = build_sharded_train_step(
        _chunked(b.loss_fn, REG_REF_CHUNK), b.init_fn,
        {"tokens": meta(tokens.shape, torch.int32)}, REG_ONE, ref_plan,
        on_grads=lambda g: norms_of["reference"].append(
            float(global_norm(g))))
    p = tree_map(torch.clone, params)
    run("reference", step, p, adamw_init(p), {"tokens": tokens},
        cfg.n_layers * (REG_BATCH // REG_REF_CHUNK) * 2)
    del p, step
    release(torch)
    # the plan: pp_wave, the folded closed form at D=4
    adapter = b.make_adapter(plan, REG_MESH)
    if not (adapter.wave and adapter.pcfg.num_devices == REG_D
            and adapter.pcfg.num_microbatches == M):
        fail(f"registry smollm-360m: adapter {adapter.pcfg}, wave "
             f"{adapter.wave}")
    struct = b.batch_struct(shape, plan)
    step, _ = build_pp_train_step(
        adapter, REG_MESH, struct, plan, b.make_microbatches,
        on_grads=lambda g: norms_of["pp_wave"].append(float(global_norm(g))))
    p = adapter.split_params(tree_map(torch.clone, params))
    run("pp_wave", step, p, adamw_init(p),
        {"tokens": tokens.reshape(struct["tokens"].shape)},
        cfg.n_layers * M * 2)
    del p, step, adapter, params
    release(torch)
    ref, got = runs["reference"], runs["pp_wave"]
    rel0 = abs(got["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    rel1 = abs(got["losses"][1] - ref["losses"][1]) / abs(ref["losses"][1])
    reln = abs(got["grad_norms"][0] - ref["grad_norms"][0]) \
        / abs(ref["grad_norms"][0])
    if not (rel0 <= REG_LOSS_BAR and rel1 <= REG_BAR and reln <= REG_BAR):
        fail(f"registry smollm-360m pp_wave vs the sharded reference: step "
             f"0 loss rel {rel0:.3e} (bar {REG_LOSS_BAR}), step 1 loss rel "
             f"{rel1:.3e} and first gradient norm rel {reln:.3e} (bar "
             f"{REG_BAR})")
    rec.setdefault("registry", {})["smollm-360m"] = dict(
        plan="train_4k", strategy=plan.strategy, D=REG_D, M=M,
        seq=REG_SEQ, global_batch=REG_BATCH, loss0_rel_err=rel0,
        loss1_rel_err=rel1, grad_norm_rel_err=reln, **runs)
    log(f"[registry] smollm-360m pp_wave vs reference: step 0 loss rel "
        f"{rel0:.3e}, step 1 {rel1:.3e}, first gradient norm {reln:.3e}")
    return {"registry smollm-360m pp_wave": counts["pp_wave"],
            "registry smollm-360m reference": counts["reference"]}


def registry_internlm2(torch, rec, smi_line: str) -> dict:
    """internlm2-20b from ``get_arch`` at full width, ``scaled_cfg`` to
    ``INTERNLM_LAYERS`` of its 48 layers (bf16, seed-0 weights), on its own
    ``train_4k`` plan (``pp_1f1b``, M=16): the linear closed form at D=4
    through ``LMPipelineAdapter`` and ``build_pp_train_step``,
    ``REG_STEPS`` AdamW steps at S=4096, global batch 16.  The reference
    for step 0's loss: ``build_forward_step`` on the same weights and
    batch (a chunk of ``REG_REF_CHUNK`` rows at a time), within
    ``REG_LOSS_BAR``.  Flash launches: layers x microbatches x 2 a step,
    layers x chunks in the forward.  Returns the launches by run."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec, meta
    from repro_torch.configs.lm_common import lm_bundle
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.optim import adamw_init, global_norm
    from repro_torch.train.steps import build_forward_step, build_pp_train_step
    from repro_torch.tree import tree_leaves

    full = get_arch("internlm2-20b")
    cfg = full.scaled_cfg(INTERNLM_LAYERS)
    b = lm_bundle(full.name, cfg, full.plans)
    plan = b.plans["train_4k"]
    M = plan.microbatches
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = _reg_params(torch, b, gen)
    n_params = sum(x.numel() for x in tree_leaves(params))
    tokens = torch.randint(0, cfg.vocab, (REG_BATCH, REG_SEQ), generator=gen,
                           device="cuda", dtype=torch.int32)
    # the reference's loss first, on the same weights and batch
    fwd, _ = build_forward_step(
        _chunked(b.loss_fn, REG_REF_CHUNK), b.init_fn,
        {"tokens": meta(tokens.shape, torch.int32)}, REG_ONE,
        dataclasses.replace(plan, strategy="sharded"))
    reset_launch_counts()
    t0 = time.perf_counter()
    ref_loss = float(fwd(params, {"tokens": tokens}))
    t_fwd = time.perf_counter() - t0
    fwd_counts = launch_counts()
    fwd_want = cfg.n_layers * (REG_BATCH // REG_REF_CHUNK)
    if fwd_counts["flash_attention"] != fwd_want:
        fail(f"registry internlm2-20b forward: flash "
             f"{fwd_counts['flash_attention']}, want {fwd_want}")
    adapter = b.make_adapter(plan, REG_MESH)
    if adapter.wave or adapter.pcfg.num_devices != REG_D:
        fail(f"registry internlm2-20b: adapter {adapter.pcfg}, wave "
             f"{adapter.wave}")
    struct = b.batch_struct(ShapeSpec("registry", "train", REG_SEQ,
                                      REG_BATCH), plan)
    norms = []
    step, _ = build_pp_train_step(
        adapter, REG_MESH, struct, plan, b.make_microbatches,
        on_grads=lambda g: norms.append(float(global_norm(g))))
    p = adapter.split_params(params)
    o = adamw_init(p)
    batch = {"tokens": tokens.reshape(struct["tokens"].shape)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, secs, flash = [], [], []
    for _ in range(REG_STEPS):
        before = launch_counts()["flash_attention"]
        t0 = time.perf_counter()
        p, o, loss = step(p, o, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        flash.append(launch_counts()["flash_attention"] - before)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = cfg.n_layers * M * 2
    rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    what = f"internlm2-20b ({INTERNLM_LAYERS} of 48 layers)"
    if not all(math.isfinite(x) for x in losses + norms + [ref_loss]):
        fail(f"registry {what}: losses {losses}, forward {ref_loss}, "
             f"gradient norms {norms}")
    if any(n != want for n in flash):
        fail(f"registry {what}: flash {flash} a step, want {want}")
    if not rel <= REG_LOSS_BAR:
        fail(f"registry {what}: step 0 loss {losses[0]!r} vs "
             f"build_forward_step's "
             f"{ref_loss!r} (rel {rel:.3e} > {REG_LOSS_BAR})")
    rec.setdefault("registry", {})["internlm2-20b"] = dict(
        layers=INTERNLM_LAYERS, params=n_params, plan="train_4k",
        strategy=plan.strategy, D=REG_D, M=M, seq=REG_SEQ,
        global_batch=REG_BATCH, losses=losses, grad_norms=norms,
        step_seconds=secs, peak_bytes=peak, flash_per_step=flash,
        flash_predicted=want, forward_loss=ref_loss, forward_s=t_fwd,
        loss0_rel_err=rel)
    log(f"[registry] {what}: {n_params} params; pp_1f1b D={REG_D} M={M}; "
        f"losses {losses} (step 0 vs build_forward_step {ref_loss!r}: rel "
        f"{rel:.3e}); gradient norms {norms}; step s "
        f"{[round(x, 3) for x in secs]}; forward {t_fwd:.3f} s; peak "
        f"{peak / 1e9:.2f} GB; flash {flash} a step, want {want} "
        f"({smi_line})")
    del p, o, step, adapter, params
    return {"registry internlm2-20b pp_1f1b": counts,
            "registry internlm2-20b forward": fwd_counts}


def _int8_formula_bytes(params) -> tuple[int, int, int]:
    """Both int8 moments' bytes: 2 x (n + 4 n / 256) for n params, the
    same with each leaf's blocks padded to a multiple of 32 x 256, and
    fp32's 8 n."""
    n = padded = 0
    for x in _leaves(params):
        n += x.numel()
        padded += -(-x.numel() // 8192) * 8192
    return 2 * (n + 4 * n // 256), 2 * (padded + 4 * padded // 256), 8 * n


def registry_qwen3_int8(torch, rec, smi_line: str) -> dict:
    """qwen3-moe-30b-a3b from ``get_arch``, ``scaled_cfg(2)`` (2 of 48
    layers at full width, the lm phase's cut; bf16, seed-0 weights), its
    ``train_4k`` plan with ``int8_optimizer=True`` (its TP/EP axis of size
    1 a no-op): one step of ``build_sharded_train_step`` (a value-and-grad
    and an int8 AdamW step) at S=4096, batch 2, then the loss again.
    Held: finite losses and gradient norm; flash 2 a layer in the step and
    1 a layer after; the peak below the lm phase's fp32-AdamW run
    (``QWEN_FP32_PEAK_GB``); the moments' bytes equal to their formula
    with padding.  Returns the launches."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import meta
    from repro_torch.configs.lm_common import lm_bundle
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.optim import global_norm, int8_adamw_init
    from repro_torch.train.steps import build_sharded_train_step

    full = get_arch("qwen3-moe-30b-a3b")
    cfg = full.scaled_cfg(QWEN_LAYERS)
    b = lm_bundle(full.name, cfg, full.plans)
    plan = dataclasses.replace(b.plans["train_4k"], int8_optimizer=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = _reg_params(torch, b, gen)
    n_params = sum(x.numel() for x in _leaves(params))
    tokens = torch.randint(0, cfg.vocab, (QWEN_BATCH, REG_SEQ),
                           generator=gen, device="cuda", dtype=torch.int32)
    norms = []
    step, (_, o_struct, _) = build_sharded_train_step(
        b.loss_fn, b.init_fn, {"tokens": meta(tokens.shape, torch.int32)},
        REG_ONE, plan, on_grads=lambda g: norms.append(float(global_norm(g))))
    opt = int8_adamw_init(params)
    moment_bytes = _tree_bytes((opt["m"], opt["v"]))
    formula, formula_padded, fp32_bytes = _int8_formula_bytes(params)
    if moment_bytes != formula_padded or \
            _tree_bytes((o_struct["m"], o_struct["v"])) != formula_padded:
        fail(f"registry qwen3 int8: moments {moment_bytes} B, the formula "
             f"with padding {formula_padded}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    params, opt, loss = step(params, opt, {"tokens": tokens})
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    in_step = launch_counts()
    with torch.no_grad():
        after = float(b.loss_fn(params, {"tokens": tokens}))
    peak = torch.cuda.max_memory_allocated()
    loss = float(loss)
    what = f"qwen3-moe-30b-a3b int8 ({QWEN_LAYERS} of 48 layers)"
    if not all(math.isfinite(x) for x in [loss, after] + norms):
        fail(f"registry {what}: loss {loss}, after {after}, gradient norm "
             f"{norms}")
    want = 2 * QWEN_LAYERS
    if in_step["flash_attention"] != want or \
            launch_counts()["flash_attention"] != want + QWEN_LAYERS:
        fail(f"registry {what}: flash {in_step['flash_attention']} in the step (want "
             f"{want}), {launch_counts()['flash_attention']} with the loss "
             f"after (want {want + QWEN_LAYERS})")
    if not peak < QWEN_FP32_PEAK_GB * 1e9:
        fail(f"registry {what}: peak {peak / 1e9:.2f} GB, not below the "
             f"fp32-AdamW "
             f"run's {QWEN_FP32_PEAK_GB} GB")
    rec.setdefault("registry", {})["qwen3-moe-30b-a3b int8"] = dict(
        layers=QWEN_LAYERS, params=n_params, seq=REG_SEQ, batch=QWEN_BATCH,
        loss=loss, loss_after=after, grad_norm=norms[0], step_s=t_step,
        peak_bytes=peak, fp32_adamw_peak_gb=QWEN_FP32_PEAK_GB,
        moment_bytes=moment_bytes, formula_bytes=formula,
        formula_padded_bytes=formula_padded, fp32_moment_bytes=fp32_bytes,
        launches=launch_counts())
    log(f"[registry] {what}: {n_params} params; S={REG_SEQ} B={QWEN_BATCH}; "
        f"loss {loss!r}, after the int8 AdamW step {after!r}; gradient norm "
        f"{norms[0]!r}; step {t_step:.3f} s; peak {peak / 1e9:.2f} GB "
        f"(fp32 AdamW, lm phase: {QWEN_FP32_PEAK_GB} GB); moments "
        f"{moment_bytes} B = 2 x (n + 4n/256) with padding ({formula} B "
        f"without; fp32 8n = {fp32_bytes} B) ({smi_line})")
    del params, opt, step
    return launch_counts()


def registry_serve(torch, rec, smi_line: str) -> dict:
    """smollm-360m from ``get_arch`` (seed-0 weights): the serve phase's
    batch of 16 prompts of 2048 prefilled (``lm.prefill``, caches of
    prompt + 1 + ``REG_SERVE_STEPS`` rows), then ``REG_SERVE_STEPS`` greedy
    steps of ``build_sharded_serve_step`` over the bundle's
    ``make_decode_fn`` on its ``decode_32k`` plan (TP over a ``model``
    axis of size 1: a no-op).  Held: the tokens equal
    ``launch.serve.generate``'s from the same weights and prompts; the
    caches' shapes the bundle's ``cache_struct``'s; flash once a layer a
    step.  Returns the launches of the serve steps."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec, meta
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm
    from repro_torch.train.steps import build_sharded_serve_step

    b = get_arch("smollm-360m")
    cfg = b.cfg
    B, P, G = SERVE_LM["batch"], SERVE_LM["prompt"], REG_SERVE_STEPS + 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = _reg_params(torch, b, gen)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen,
                            device="cuda", dtype=torch.int32)
    shape = ShapeSpec("registry", "decode", P + G, B)
    struct = b.cache_struct(shape)
    step, _ = build_sharded_serve_step(
        b.make_decode_fn(shape), b.init_fn, struct,
        meta((B, 1), torch.int32), REG_ONE, b.plans["decode_32k"])
    with torch.inference_mode():
        logits, caches = lm.prefill(params, prompts, cfg, P + G)
    got = {k: (tuple(v.shape), v.dtype) for k, v in caches["layers"].items()
           if k != "pos"}
    if got != {k: (tuple(v.shape), v.dtype) for k, v in
               struct["layers"].items() if k != "pos"}:
        fail(f"registry serve: caches {got} vs cache_struct "
             f"{struct['layers']}")
    tok = torch.argmax(logits, -1).to(torch.int32)
    toks = [tok]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(REG_SERVE_STEPS):
        tok, caches = step(params, tok, caches)
        toks.append(tok)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    tokens = torch.cat(toks, 1)
    want = generate(params, cfg, prompts, G).tokens
    equal = bool(torch.equal(tokens, want))
    flash_want = cfg.n_layers * REG_SERVE_STEPS
    if not equal:
        fail(f"registry serve: tokens differ from generate's at "
             f"{int((tokens != want).sum())} of {tokens.numel()}")
    if counts["flash_attention"] != flash_want:
        fail(f"registry serve: flash {counts['flash_attention']}, want "
             f"{flash_want}")
    rec.setdefault("registry", {})["serve smollm-360m"] = dict(
        batch=B, prompt=P, steps=REG_SERVE_STEPS, tokens_equal=equal,
        step_ms=1e3 * secs / REG_SERVE_STEPS, launches=counts)
    log(f"[registry] smollm-360m serve: B={B} prompt {P}, "
        f"{REG_SERVE_STEPS} steps of build_sharded_serve_step, "
        f"{1e3 * secs / REG_SERVE_STEPS:.2f} ms a step; tokens equal "
        f"generate's; flash {counts['flash_attention']} ({smi_line})")
    del params, caches
    return counts


# ---------------------------------------------------------------------------
# phase 12: ranks -- UViT-H with one process per pipeline device, four
# ranks on the one card over the gloo ring staged through host memory
# ---------------------------------------------------------------------------

RANKS_D = 4
RANKS_STEPS = 3
RANKS_ARGV = ["--arch", "uvit-h", "--pipeline", "--devices", str(RANKS_D),
              "--microbatches", "8", "--global-batch", "16", "--steps",
              str(RANKS_STEPS), "--log-every", "1", "--ring", "gloo",
              "--device", "cuda"]
RANKS_TIMEOUT = 900          # seconds for the whole torchrun (a rank
#                              waiting on a peer fails after 600 s)
FINGERPRINT_BAR = 1e-2       # ||err|| / ||g|| per gradient leaf


def _fingerprint_errs(got: dict, want: dict) -> tuple[float, str]:
    """Worst ||err|| / ||g|| over the leaves, each estimated from the
    fingerprints (``train.grad_fingerprints``): the larger of the norms'
    difference and the root mean square of the probe dots' differences.
    A leaf whose gradient is zero in ``want`` must be zero in ``got``."""
    worst, at = 0.0, ""
    for k, w in want.items():
        g = got[k]
        dots = [a - b for a, b in zip(g[1:], w[1:])]
        err = max(abs(g[0] - w[0]),
                  math.sqrt(sum(x * x for x in dots) / len(dots)))
        rel = err / w[0] if w[0] else (0.0 if err == 0 else math.inf)
        if rel > worst or not at:
            worst, at = rel, k
    return worst, at


def ranks_phase(torch, rec, smi_line: str) -> dict:
    """Four ranks of ``repro_torch.launch.train`` on the one card
    (``torch.distributed.run --standalone --nproc-per-node 4``, ``--ring
    gloo --device cuda``: payloads staged through pinned host memory), the
    UViT-H plan of phase 6.  Each rank (``--rank-report``) runs
    ``RANKS_STEPS`` AdamW steps from the same seed-0 params and batches as
    phase 6 (the probe: the first step's forward+backward, read before its
    update), then one forward+backward of the skip-carry baseline from
    those params.
    Held: the first loss to phase 6's at rtol 1e-5, AdamW steps 1-2 at
    2e-2; each gradient leaf's fingerprint to phase 6's step 0 at
    ``FINGERPRINT_BAR``; the table walk's ring bytes, each direction, to
    phase 6's ``HOP_BYTES`` live count a step, exactly, and the
    baseline's to the baseline phase's; the ranks' flash and skip
    launches of the probe to phase 6's a step (more would mean some op
    back-propagated twice); the baseline's loss to the table walk's at
    rtol 1e-5.  Printed: each rank's peaks beside Eq. 14's per-device
    prediction, and the step seconds.  The ranks load the kernels phase 2
    built (``REPRO_TORCH_NO_BUILD=1``).  Returns the ranks' launches."""
    import shutil

    from repro_torch.core.comm_model import WIRE_BYTES
    from repro_torch.core.hw import H100_SXM
    from repro_torch.core.tuner import peak_memory, profile_partition
    from repro_torch.launch import train as train_mod
    from repro_torch.models.diffusion import uvit_pipeline_graph
    from repro_torch.runtime.adapters import model_fns
    from repro_torch.runtime.compile import auto_pipeline

    t_phase = time.perf_counter()
    one = rec["train"]["uvit-h"]
    base_row = rec["baseline"]["executors"]["skip_carry"]
    out_dir = os.path.join(ROOT, "build", "chip_smoke_ranks")
    shutil.rmtree(out_dir, ignore_errors=True)
    env = dict(os.environ, REPRO_TORCH_NO_BUILD="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src")]
                   + [p for p in os.environ.get("PYTHONPATH", "").split(
                       os.pathsep) if p]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(RANKS_D), "-m", "repro_torch.launch.train",
           *RANKS_ARGV, "--rank-report", out_dir]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=RANKS_TIMEOUT)
    wall = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "ranks.log"), "w") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode != 0:
        fail(f"ranks: torchrun exited {proc.returncode}:\n"
             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    docs = []
    for r in range(RANKS_D):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            docs.append(json.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)
    for d in docs:
        if not d["device"].startswith("cuda") or d["ring"] != "gloo" \
                or not d["staged"]:
            fail(f"ranks: rank {d['rank']} ran on {d['device']} over "
                 f"{d['ring']} (staged {d['staged']})")
    what = "ranks"

    # losses
    first = one["losses"][0]
    probe_losses = [d["probe"]["loss"] for d in docs]
    train_losses = [[d["train"]["losses"][str(s)] for s in range(RANKS_STEPS)]
                    for d in docs]
    if len({*probe_losses}) != 1 or any(x != train_losses[0]
                                         for x in train_losses):
        fail(f"{what}: the ranks disagree on the loss: probe "
             f"{probe_losses}, steps {train_losses}")
    loss0 = probe_losses[0]
    if not math.isclose(loss0, first, rel_tol=1e-5) or not math.isclose(
            train_losses[0][0], first, rel_tol=1e-5):
        fail(f"{what}: first loss {loss0} (step 0 {train_losses[0][0]}) vs "
             f"phase 6's {first} (rtol 1e-5)")
    for s in (1, 2):
        a, b = train_losses[0][s], one["losses"][s]
        if not (math.isfinite(a) and abs(a - b) <= 2e-2 * abs(b)):
            fail(f"{what}: AdamW step {s} loss {a} vs phase 6's {b} "
                 "(rtol 2e-2)")
    if any(d["train"]["skipped_steps"] for d in docs):
        fail(f"{what}: a rank skipped a step")

    # gradient fingerprints against phase 6's step 0
    got = {}
    for d in docs:
        for k, v in d["probe"]["fingerprints"].items():
            if k.startswith("edge/"):
                k = f"{k} (rank {d['rank']})"
            got[k] = v
    want = {}
    for k, v in one["fingerprints"].items():
        if k.startswith("edge/"):
            want.update({f"{k} (rank {r})": v for r in range(RANKS_D)})
        else:
            want[k] = v
    if sorted(got) != sorted(want):
        fail(f"{what}: fingerprint keys differ: "
             f"{sorted(set(got) ^ set(want))[:10]}")
    worst, worst_at = _fingerprint_errs(got, want)
    if worst > FINGERPRINT_BAR:
        fail(f"{what}: gradient {worst_at} ||err||/||g|| {worst:.3e} "
             f"against phase 6's step 0 (bar {FINGERPRINT_BAR})")

    # ring bytes, each direction, exact
    def ring_sum(key):
        return {f"{p} {k}": sum(d[key]["ring_bytes"][p][k] for d in docs)
                for p in ("fwd", "bwd") for k in ("sent", "received")}

    table_bytes, base_bytes = ring_sum("probe"), ring_sum("baseline")
    live = one["hop_bytes_per_step"]["live"]
    base_live = base_row["hop_bytes_per_step"]["live"]
    if set(table_bytes.values()) != {live}:
        fail(f"{what}: table walk ring bytes {table_bytes}, want "
             f"{live} (phase 6's HOP_BYTES live a step) each")
    if set(base_bytes.values()) != {base_live}:
        fail(f"{what}: skip-carry ring bytes {base_bytes}, want "
             f"{base_live} (the baseline phase's live a step) each")

    # launches: the probe's, summed over the ranks, are phase 6's a step
    probe_launches = {k: sum(d["probe"]["launches"][k] for d in docs)
                      for k in docs[0]["probe"]["launches"]}
    for k in ("flash_attention", "skip_concat_matmul"):
        if probe_launches[k] != one["launches_per_step"][k]:
            fail(f"{what}: {k} launched {probe_launches[k]} times in the "
                 f"ranks' forward+backward, phase 6's step "
                 f"{one['launches_per_step'][k]}")
    base_launches = {k: sum(d["baseline"]["launches"][k] for d in docs)
                     for k in docs[0]["baseline"]["launches"]}
    for k in ("flash_attention", "skip_concat_matmul"):
        if base_launches[k] != one["launches_per_step"][k]:
            fail(f"{what}: the baseline launched {k} {base_launches[k]} "
                 f"times, phase 6's step {one['launches_per_step'][k]}")
    base_loss = docs[0]["baseline"]["loss"]
    if not math.isclose(base_loss, loss0, rel_tol=1e-5):
        fail(f"{what}: skip-carry loss {base_loss} vs the table walk's "
             f"{loss0} (rtol 1e-5)")
    cf = closed_form_probe(docs, one, loss0, table_bytes, live, want, what)
    launched = {k: sum(d["launches"][k] for d in docs)
                for k in docs[0]["launches"]}

    # Eq. 14's per-device prediction for the plan (prints, not gates)
    cfg = train_mod._model_config(train_mod._parse_args(RANKS_ARGV))
    graph = uvit_pipeline_graph(cfg, batch=2, hw=H100_SXM)
    cp = auto_pipeline(graph, model_fns(cfg, "uvit"), RANKS_D, hw=H100_SXM,
                       pipeline_devices=RANKS_D, microbatches=8,
                       wire_dtype="bfloat16")
    tabs = cp.step_tables()
    # one microbatch of the graph's batch (2 samples) is b = 1
    predicted = peak_memory(
        profile_partition(graph, cp.partition), RANKS_D, 1, wave=True,
        windows=(tabs.W_down + tabs.W_up, tabs.W_turn, tabs.W_skip),
        wire_bytes=WIRE_BYTES["bfloat16"])
    steps = {s: [d["train"]["step_seconds"][str(s)] for d in docs]
             for s in range(RANKS_STEPS)}
    step_max = [max(v) for v in steps.values()]
    steady = step_max[1:]
    out = dict(
        card=smi_line, argv=RANKS_ARGV, wall_s=wall,
        first_loss=loss0, phase6_first_loss=first, losses=train_losses[0],
        phase6_losses=one["losses"][:RANKS_STEPS],
        worst_rel_grad_err=worst, worst_grad=worst_at,
        ring_bytes_table=table_bytes, ring_bytes_skip_carry=base_bytes,
        hop_bytes_live=live, hop_bytes_live_skip_carry=base_live,
        reduction=1 - table_bytes["fwd sent"] / base_bytes["fwd sent"],
        probe_launches=probe_launches, baseline_launches=base_launches,
        baseline_loss=base_loss, launches=launched,
        probe_seconds=[d["probe"]["seconds"] for d in docs],
        baseline_seconds=[d["baseline"]["seconds"] for d in docs],
        step_seconds=steps, step_seconds_max=step_max,
        spread_after_first=(max(steady) - min(steady)) if steady else None,
        peaks={d["rank"]: dict(init=d["probe"]["init_peak_bytes"],
                               probe=d["probe"]["peak_bytes"],
                               train=d["train"]["peak_bytes"],
                               baseline=d["baseline"]["peak_bytes"])
               for d in docs},
        eq14_per_device_bytes=predicted, nccl="not run (1 card)",
        closed_form=cf)
    rec["ranks"] = out
    log(f"[ranks] UViT-H D={RANKS_D} M=8 b=2, four ranks on one card over "
        f"the gloo ring (staged through pinned host memory); torchrun "
        f"{wall:.1f} s; {smi_line}")
    log(f"[ranks] first loss {loss0!r} (phase 6 {first!r}); AdamW losses "
        f"{train_losses[0]} (phase 6 {one['losses'][:RANKS_STEPS]}); "
        f"skip-carry loss {base_loss!r}")
    log(f"[ranks] gradient fingerprints vs phase 6's step 0: worst "
        f"||err||/||g|| {worst:.3e} ({worst_at}) over {len(want)} leaves")
    log(f"[ranks] ring bytes, table walk (bf16 wire): {table_bytes} = "
        f"HOP_BYTES live {live}; skip-carry: {base_bytes} = {base_live}; "
        f"PULSE moves {100 * out['reduction']:.1f} % less")
    log(f"[ranks] launches of the forward+backward summed over the ranks: "
        f"table {probe_launches}, skip-carry {base_launches}; whole run "
        f"{launched}")
    log(f"[ranks] closed-form wave over the ranks: loss {cf['loss']!r} "
        f"(table walk {loss0!r}, rel {cf['loss_rel_err']:.2e}); gradient "
        f"fingerprints vs phase 6's step 0: worst ||err||/||g|| "
        f"{cf['worst_rel_grad_err']:.3e} ({cf['worst_grad']}); ring bytes "
        f"{cf['ring_bytes']} = the table walk's = HOP_BYTES live {live}; "
        f"launches {cf['launches']}; seconds "
        f"{[round(x, 3) for x in cf['seconds']]}; peak GB "
        f"{[round(x / 1e9, 3) for x in cf['peak_bytes']]}")
    for d in docs:
        pk = out["peaks"][d["rank"]]
        log(f"[ranks] rank {d['rank']}: peak GB set-up (the whole model "
            f"drawn, then its rows kept) {pk['init'] / 1e9:.3f}, probe "
            f"{pk['probe'] / 1e9:.3f}, train {pk['train'] / 1e9:.3f}, "
            f"skip-carry {pk['baseline'] / 1e9:.3f}; Eq. 14 per device "
            f"{predicted / 1e9:.3f}; probe {d['probe']['seconds']:.3f} s, "
            f"skip-carry {d['baseline']['seconds']:.3f} s")
    log(f"[ranks] step s (slowest rank) {[round(x, 4) for x in step_max]}; "
        f"spread after step 0 {out['spread_after_first']}; "
        f"nccl: not run (1 card); phase {time.perf_counter() - t_phase:.1f} s")
    return launched


def closed_form_probe(docs: list, one: dict, loss0: float, table_bytes: dict,
                      live: int, want: dict, what: str) -> dict:
    """The ranks' closed-form wave (``executor="closed_form"`` over the
    same ring, the same seed-0 params and step 0's batch): its loss
    against the table walk's probe at rtol 1e-5 (the bar the skip-carry
    baseline meets), its gradient fingerprints against phase 6's step 0
    at ``FINGERPRINT_BAR``, its ring bytes, each direction, equal to the
    table walk's and to ``HOP_BYTES``' live count (the stash never crosses
    the ring), its flash and skip launches summed over the ranks equal to
    phase 6's a step."""
    cfs = [d["closed_form"] for d in docs]
    if any(c is None for c in cfs):
        fail(f"{what}: a rank ran no closed-form probe")
    losses = {c["loss"] for c in cfs}
    if len(losses) != 1:
        fail(f"{what}: the ranks disagree on the closed form's loss "
             f"{sorted(losses)}")
    loss = cfs[0]["loss"]
    rel = abs(loss - loss0) / abs(loss0)
    if not rel <= 1e-5:
        fail(f"{what}: closed-form loss {loss} vs the table walk's {loss0} "
             "(rtol 1e-5)")
    got = {}
    for d in docs:
        for k, v in d["closed_form"]["fingerprints"].items():
            got[f"{k} (rank {d['rank']})" if k.startswith("edge/") else k] = v
    if sorted(got) != sorted(want):
        fail(f"{what}: closed-form fingerprint keys differ: "
             f"{sorted(set(got) ^ set(want))[:10]}")
    worst, worst_at = _fingerprint_errs(got, want)
    if worst > FINGERPRINT_BAR:
        fail(f"{what}: closed-form gradient {worst_at} ||err||/||g|| "
             f"{worst:.3e} against phase 6's step 0 (bar {FINGERPRINT_BAR})")
    nbytes = {f"{p} {k}": sum(c["ring_bytes"][p][k] for c in cfs)
              for p in ("fwd", "bwd") for k in ("sent", "received")}
    if nbytes != table_bytes or set(nbytes.values()) != {live}:
        fail(f"{what}: closed-form ring bytes {nbytes}, the table walk's "
             f"{table_bytes}, HOP_BYTES live {live}")
    launches = {k: sum(c["launches"][k] for c in cfs)
                for k in cfs[0]["launches"]}
    for k in ("flash_attention", "skip_concat_matmul"):
        if launches[k] != one["launches_per_step"][k]:
            fail(f"{what}: the closed form launched {k} {launches[k]} times, "
                 f"phase 6's step {one['launches_per_step'][k]}")
    return dict(loss=loss, loss_rel_err=rel, worst_rel_grad_err=worst,
                worst_grad=worst_at, ring_bytes=nbytes, launches=launches,
                seconds=[c["seconds"] for c in cfs],
                peak_bytes=[c["peak_bytes"] for c in cfs])


# ---------------------------------------------------------------------------
# phase 12b: lm ranks -- smollm-360m at full width (8 layers) on wave-zero2's
# plan shape (P=2, dp=2, ZeRO-2), four rank processes on the one card
# ---------------------------------------------------------------------------

LM_RANKS_DP, LM_RANKS_PP = 2, 2
LM_RANKS_STEPS = 2
LM_RANKS_TIMEOUT = 900


def _lm_ranks_plan():
    """wave-zero2's plan shape at smollm-360m's full width and depth: the
    folded wave (``force_wave``) over P=2 pipeline devices, two ZeRO-2
    data replicas, M=8; each replica's microbatch is one sequence."""
    CFG = _lm_smollm_cfg()
    from repro_torch.models import lm
    from repro_torch.runtime.adapters import lm_model_fns
    from repro_torch.runtime.compile import auto_pipeline
    b = LM_BATCH // LM_M // LM_RANKS_DP
    return auto_pipeline(lm.lm_pipeline_graph(CFG, batch=b, seq=LM_SEQ),
                         lm_model_fns(CFG), LM_RANKS_DP * LM_RANKS_PP,
                         pipeline_devices=LM_RANKS_PP,
                         dp_size=LM_RANKS_DP, zero_stage=2,
                         microbatches=LM_M, force_wave=True)


def lm_rank_worker(rank: int, port: int, out_dir: str) -> None:
    """One rank of the ``lm ranks`` phase (``chip_smoke.py --lm-rank R
    --port P --out DIR``): smollm-360m's seed-0 weights and batch drawn as
    the ``lm`` phase draws them, the rank's shard of its rows kept,
    ``LM_RANKS_STEPS`` AdamW steps (lr 3e-4, the norm over the grid)
    through ``build_pp_train_step`` over the rank grid on
    ``_lm_ranks_plan``'s ``CompiledPipeline``, each step's loss, seconds,
    peak, ring and data-group bytes and launches written to
    DIR/rank<R>.json."""
    import datetime

    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    CFG = _lm_smollm_cfg()
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.mesh import make_rank_grid
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.adapters import make_lm_microbatches
    from repro_torch.train.steps import ParallelPlan, build_pp_train_step
    from repro_torch.tree import tree_map

    world = LM_RANKS_DP * LM_RANKS_PP
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    grid = make_rank_grid(LM_RANKS_PP, dp=LM_RANKS_DP)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        whole = lm.init_lm(gen, CFG, "cuda")
    tokens = torch.randint(0, CFG.vocab, (LM_BATCH, LM_SEQ), generator=gen,
                           device="cuda", dtype=torch.int32)
    digest = lm_digest(torch, whole, tokens)
    plan = ParallelPlan(strategy="pp_wave", pp_degree=LM_RANKS_PP,
                        microbatches=LM_M, zero_stage=2)
    step, _ = build_pp_train_step(
        _lm_ranks_plan(), grid, {"tokens": tokens.to("meta")}, plan,
        lambda batch, rng, edge: (make_lm_microbatches(batch, LM_M), {}),
        AdamWConfig(lr=3e-4))
    with torch.no_grad():
        params = tree_map(torch.clone, step.split_params(whole))
    del whole
    torch.cuda.empty_cache()
    init_peak = torch.cuda.max_memory_allocated()
    opt = adamw_init(step.optimizer_view(params))
    steps = []
    for _ in range(LM_RANKS_STEPS):
        for g in (step.state.get("ring"), step.state.get("data")):
            if g is not None:
                g.reset_bytes()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, {"tokens": tokens})
        torch.cuda.synchronize()
        after = launch_counts()
        ring, data = step.state["ring"], step.state["data"]
        steps.append(dict(
            loss=float(loss), finite=bool(step.finite),
            norm=float(step.grad_norm),
            seconds=time.perf_counter() - t0,
            peak_bytes=torch.cuda.max_memory_allocated(),
            ring_bytes=json.loads(json.dumps(ring.bytes)),
            data_bytes=dict(data.bytes), data_calls=dict(data.calls),
            data_seconds=dict(data.seconds),
            launches={k: v - before[k] for k, v in after.items()}))
        del loss
    doc = dict(rank=rank, pipe=grid.pipe_index, data=grid.data_index,
               digest=digest, init_peak_bytes=init_peak, steps=steps,
               launches=launch_counts())
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(doc, f)
    dist.barrier()
    dist.destroy_process_group()


def lm_ranks_phase(torch, rec, smi_line: str) -> dict:
    """smollm-360m (``LM_LAYERS`` layers, S=4096, global batch 16, bf16,
    seed-0) over four rank processes on the one card (gloo, staged through pinned host
    memory): ``_lm_ranks_plan``'s two ZeRO-2 replicas of a P=2 wave,
    ``LM_RANKS_STEPS`` AdamW steps.  Held: every rank's loss equal, every
    step's against the ``lm`` phase's non-pipeline ``lm_loss`` + AdamW
    reference at ``LM_TRAJ_BAR`` (the same weights and batch: its digest
    is checked, else the reference is not reused and the phase fails), so
    the steps after the first hold the update each rank applied; every
    rank's gradient finite on every step (a step it skips fails the
    phase); every rank's step-0 gradient norm over the grid against the
    reference's at ``LM_BAR``; each replica's ring bytes, each
    direction, equal to its live hops times a microbatch's activation
    bytes; each rank's data-group bytes and calls of a step equal to
    ``hybrid_bytes``; the flash launches of a step, summed over the ranks,
    equal to the tables' count for both replicas.  Printed: each rank's
    step seconds and peak memory.  Returns the ranks' launches."""
    import shutil
    import socket

    CFG = _lm_smollm_cfg()
    t_phase = time.perf_counter()
    what = "lm ranks"
    ref = rec["lm"]["smollm-360m"]
    out_dir = os.path.join(ROOT, "build", "chip_smoke_lm_ranks")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, REPRO_TORCH_NO_BUILD="1")
    world = LM_RANKS_DP * LM_RANKS_PP
    logs = [open(os.path.join(OUT_DIR, f"lm_ranks.r{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--lm-rank", str(r),
         "--port", str(port), "--out", out_dir], env=env, cwd=ROOT,
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    t0 = time.perf_counter()
    try:
        codes = [p.wait(timeout=LM_RANKS_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    if any(codes):
        tails = []
        for r in range(world):
            with open(os.path.join(OUT_DIR, f"lm_ranks.r{r}.log")) as f:
                tails.append(f"rank {r}:\n{f.read()[-2000:]}")
        fail(f"{what}: rank exit codes {codes}\n" + "\n".join(tails))
    docs = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            docs.append(json.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)

    # the weights and batch are the lm phase's: its reference applies
    for d in docs:
        if d["digest"] != ref["digest"]:
            fail(f"{what}: rank {d['rank']} drew weights and batch "
                 f"{d['digest']}, the lm phase {ref['digest']}")
    losses = [[st["loss"] for st in d["steps"]] for d in docs]
    if any(x != losses[0] for x in losses):
        fail(f"{what}: the ranks disagree on the losses {losses}")
    losses = losses[0]
    rel = [abs(x - r) / abs(r) for x, r in zip(losses,
                                                 ref["reference_losses"])]
    if not all(math.isfinite(x) for x in losses) or not max(rel) <= \
            LM_TRAJ_BAR:
        fail(f"{what}: losses {losses} vs the lm phase's non-pipeline "
             f"lm_loss + AdamW {ref['reference_losses']} (relative {rel}, "
             f"bar {LM_TRAJ_BAR})")
    # every rank's gradient finite (else it skipped the update), and the
    # step-0 norm over the grid the reference's
    for d in docs:
        skipped = [s for s, st in enumerate(d["steps"]) if not st["finite"]]
        if skipped:
            fail(f"{what}: rank {d['rank']} found a non-finite gradient and "
                 f"skipped the update at steps {skipped}")
    norms = {d["rank"]: [st["norm"] for st in d["steps"]] for d in docs}
    first = {r: n[0] for r, n in norms.items()}
    ref_norm = ref["reference_grad_norms"][0]
    norm_rel = {r: abs(n - ref_norm) / abs(ref_norm)
                for r, n in first.items()}
    if not max(norm_rel.values()) <= LM_BAR:
        fail(f"{what}: step-0 gradient norms by rank {first} vs the "
             f"non-pipeline {ref_norm} (relative {norm_rel}, bar {LM_BAR})")

    # bytes: each replica's ring, each rank's data group, every step
    cp = _lm_ranks_plan()
    live_d, live_u = cp.step_tables().live_hops
    act = (LM_BATCH // LM_M // LM_RANKS_DP) * LM_SEQ * CFG.d_model * 2
    ring_want = (live_d + live_u) * act
    for di in range(LM_RANKS_DP):
        for s in range(LM_RANKS_STEPS):
            got = {f"{p} {k}": sum(d["steps"][s]["ring_bytes"][p][k]
                                   for d in docs if d["data"] == di)
                   for p in ("fwd", "bwd") for k in ("sent", "received")}
            if set(got.values()) != {ring_want}:
                fail(f"{what}: replica {di} step {s} ring bytes {got}, want "
                     f"{ring_want} ({live_d}+{live_u} live hops x {act} "
                     "bytes) each")
    data_want = {}
    for d in docs:
        nb, calls = hybrid_bytes(cp.for_rank(d["pipe"], d["data"]),
                                 d["pipe"], True)
        data_want[d["rank"]] = nb
        for s, st in enumerate(d["steps"]):
            if st["data_bytes"] != nb or st["data_calls"] != calls:
                fail(f"{what}: rank {d['rank']} step {s} data group "
                     f"{st['data_bytes']} in {st['data_calls']}, want {nb} "
                     f"in {calls}")

    # launches: flash a step, summed over the ranks, is both replicas'
    flash_want = LM_RANKS_DP * _lm_predicted_flash(cp)
    flash = [sum(d["steps"][s]["launches"]["flash_attention"] for d in docs)
             for s in range(LM_RANKS_STEPS)]
    if any(n != flash_want for n in flash):
        fail(f"{what}: flash launches a step {flash}, the tables predict "
             f"{flash_want}")
    launched = {k: sum(d["launches"][k] for d in docs)
                for k in docs[0]["launches"]}
    secs = {d["rank"]: [round(st["seconds"], 3) for st in d["steps"]]
            for d in docs}
    peaks = {d["rank"]: [st["peak_bytes"] for st in d["steps"]]
             for d in docs}
    rec["lm_ranks"] = dict(
        card=smi_line, dp=LM_RANKS_DP, pp=LM_RANKS_PP, zero_stage=2, M=LM_M,
        seq=LM_SEQ, global_batch=LM_BATCH, cuts=list(cp.partition.cuts),
        wall_s=wall, losses=losses, reference_losses=ref["reference_losses"],
        loss_rel_err=rel, grad_norms=norms,
        reference_grad_norm=ref_norm, first_grad_norm_rel_err=norm_rel,
        step_seconds=secs, peak_bytes=peaks,
        init_peak_bytes={d["rank"]: d["init_peak_bytes"] for d in docs},
        ring_bytes_per_replica_step=ring_want, live_hops=[live_d, live_u],
        data_bytes_per_step=data_want,
        data_seconds={d["rank"]: [st["data_seconds"] for st in d["steps"]]
                      for d in docs},
        flash_per_step=flash, flash_predicted=flash_want, launches=launched)
    log(f"[lm ranks] smollm-360m, {LM_LAYERS} layers, S={LM_SEQ}, global "
        f"batch {LM_BATCH}: P={LM_RANKS_PP} wave x dp={LM_RANKS_DP} ZeRO-2, M={LM_M}"
        f", cuts {list(cp.partition.cuts)}; four ranks on one card (gloo, "
        f"staged); {wall:.1f} s; {smi_line}")
    log(f"[lm ranks] losses {losses} vs lm_loss + AdamW "
        f"{ref['reference_losses']} (relative "
        f"{[f'{x:.2e}' for x in rel]}, bar {LM_TRAJ_BAR})")
    log(f"[lm ranks] step-0 gradient norm by rank {first} vs lm_loss's "
        f"{ref_norm!r} (relative {max(norm_rel.values()):.2e} at most, bar "
        f"{LM_BAR}); every rank's gradient finite every step")
    log(f"[lm ranks] ring bytes a replica's step, each direction: "
        f"{ring_want} = {live_d}+{live_u} live hops x {act}; data group a "
        f"step by rank: {data_want} = their arithmetic")
    log(f"[lm ranks] flash a step over the ranks {flash} = the tables' "
        f"{flash_want} (B=1 Hq=15 Hkv=5 D=64, causal)")
    for d in docs:
        log(f"[lm ranks] rank {d['rank']} (pipe {d['pipe']}, data "
            f"{d['data']}): step s {secs[d['rank']]}; peak GB "
            f"{[round(x / 1e9, 3) for x in peaks[d['rank']]]} (set-up "
            f"{d['init_peak_bytes'] / 1e9:.3f})")
    log(f"[lm ranks] phase {time.perf_counter() - t_phase:.1f} s")
    return launched


# ---------------------------------------------------------------------------
# phase 12c: sharded ranks -- the JAX package's sharded strategy over a
# (data=2, model=2) grid of four rank processes on the one card: the SDv2
# UNet at full width on its own train_4k plan (FSDP over model x data,
# batch over data), whisper-base's prefill and decode plans (FSDP over
# model, batch over data)
# ---------------------------------------------------------------------------

SHARDED_DP, SHARDED_PP = 2, 2
SHARDED_STEPS = 2
SHARDED_BATCH = 16           # the UNet's global batch, 8 a data replica
SHARDED_LR = 3e-4
SHARDED_LOSS0_BAR = 1e-3     # bf16: step 0's loss vs the one-process step
SHARDED_BAR = 1e-2           # bf16: step 1's loss, the norm, each block
SHARDED_WH_BAR = 1e-5        # fp32: whisper's forward loss vs one process
SHARDED_SERVE_STEPS = 16
SHARDED_TIMEOUT = 900
WHISPER_SERVE_FLASH = 12     # a decode step: 6 self over the cache, 6 cross


def _sharded_unet(torch):
    """The UNet of the phase (``configs/sdv2_unet.CFG``, flash on, as
    ``factory(kernels=True)``) as ``(loss_fn, init_fn, cfg)``."""
    import dataclasses

    from repro_torch.configs.sdv2_unet import CFG
    from repro_torch.models import diffusion as dm
    cfg = dataclasses.replace(CFG, use_flash=True)

    def loss_fn(p, b, rng=None, *, t, noise):
        return dm.unet_loss(p, b, t, noise, cfg)
    return loss_fn, (lambda gen, device="cuda": dm.init_unet(gen, cfg,
                                                              device)), cfg


def _sharded_unet_inputs(torch, init_fn, cfg):
    """Seed-0 UNet weights, the global batch and each step's DDPM draws of
    it (the draws of the whole batch: a rank takes its rows of them), and
    their digest (fp64 sums)."""
    from repro_torch.configs.base import ddpm_draws
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        params = init_fn(gen, "cuda")
    B = SHARDED_BATCH
    batch = {"latents": torch.randn((B, cfg.img_size, cfg.img_size,
                                     cfg.in_ch), generator=gen,
                                    device="cuda").to(torch.bfloat16),
             "text_embeds": torch.randn((B, cfg.ctx_len, cfg.ctx_dim),
                                        generator=gen, device="cuda").to(
                                            torch.bfloat16)}
    draws = [dict(zip(("t", "noise"), ddpm_draws(batch["latents"], gen,
                                                 None, None)))
             for _ in range(SHARDED_STEPS)]
    digest = dict(params=sum(float(x.double().sum()) for x in
                             _leaves(params)),
                  inputs=sum(float(x.double().sum()) for x in
                             _leaves([batch, draws])))
    return params, batch, draws, digest


def _sharded_whisper_inputs(torch):
    """Seed-0 whisper-base weights (bf16), the prefill plan's batch (the
    ``recurrent`` phase's: ``WHISPER_BATCH`` x 4096 frames, 448 tokens)
    and the serve phase's frames and prompts."""
    from repro_torch.configs.whisper_base import CFG, MAX_TGT
    from repro_torch.models import whisper as wh
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        params = wh.init_whisper(gen, CFG, "cuda")
    B = WHISPER_BATCH
    batch = {"frames": torch.randn((B, RECURRENT_SEQ, CFG.d_model),
                                   generator=gen, device="cuda"),
             "tokens": torch.randint(0, CFG.vocab, (B, MAX_TGT),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32)}
    S = SERVE_WHISPER
    frames = torch.randn((S["batch"], S["frames"], CFG.d_model),
                         generator=gen, device="cuda")
    prompts = torch.randint(0, CFG.vocab, (S["batch"], S["prompt"]),
                            generator=gen, device="cuda", dtype=torch.int32)
    return params, batch, frames, prompts


def _whisper_runs(torch, mesh) -> dict:
    """whisper-base's forward (``prefill_32k``) and ``SHARDED_SERVE_STEPS``
    greedy serve steps (``decode_32k``) on ``mesh`` (a RankGrid, or one
    process's axis sizes), in bf16 and in fp32: each loss and the greedy
    tokens, the flash launches of the forward and of a serve step, the
    seconds, and each group's bytes."""
    from repro_torch.configs.whisper_base import CFG, PLANS
    from repro_torch.kernels import launch_counts
    from repro_torch.models import whisper as wh
    from repro_torch.train import steps as tsteps
    from repro_torch.tree import tree_map

    params, batch, frames, prompts = _sharded_whisper_inputs(torch)
    B = frames.shape[0]
    max_len = SERVE_WHISPER["prompt"] + SHARDED_SERVE_STEPS + 1
    out = {}
    for tag in ("bf16", "fp32"):
        p, cfg = (params, CFG) if tag == "bf16" else _fp32(torch, params,
                                                           CFG)
        init = lambda gen, device="cuda", cfg=cfg: wh.init_whisper(
            gen, cfg, device)

        def decode(params, token, cache, cfg=cfg):
            logits, dec = wh.decode_step(params, token, cache["enc_out"],
                                         cache["dec"], cfg)
            return logits, {"enc_out": cache["enc_out"], "dec": dec}

        fstep, _ = tsteps.build_forward_step(
            lambda q, b, rng=None, cfg=cfg: wh.whisper_loss(q, b, cfg),
            init, tree_map(lambda x: x.to("meta"), batch), mesh,
            PLANS["prefill_32k"])
        blocks = fstep.shard(p, fstep.in_specs[0])
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(fstep(blocks, batch))
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        fwd_flash = launch_counts()["flash_attention"] - \
            before["flash_attention"]
        del blocks
        cache_struct = {"enc_out": torch.empty(
            (B, frames.shape[1], cfg.d_model), dtype=cfg.dtype,
            device="meta"), "dec": wh.init_dec_caches(cfg, B, max_len,
                                                      device="meta")}
        sstep, _ = tsteps.build_sharded_serve_step(
            decode, init, cache_struct,
            torch.empty((B, 1), dtype=torch.int32, device="meta"), mesh,
            PLANS["decode_32k"])
        blocks = sstep.shard(p, sstep.in_specs[0])
        rows = sstep.in_specs[1]          # the token's spec cuts the rows
        with torch.inference_mode():
            logits, enc, dec = wh.prefill(
                p, sstep.local(frames, rows), sstep.local(prompts, rows),
                cfg, max_len)
            tok = sstep.gather_rows(torch.argmax(logits, -1).to(
                torch.int32))
            cache = {"enc_out": enc, "dec": dec}
            toks, flash = [tok], []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SHARDED_SERVE_STEPS):
                before = launch_counts()["flash_attention"]
                mine, cache = sstep(blocks, tok, cache)
                flash.append(launch_counts()["flash_attention"] - before)
                tok = sstep.gather_rows(mine)
                toks.append(tok)
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t0
        groups = {}
        for st in (fstep, sstep):
            if st.comm is not None:
                for k, g in st.comm.groups.items():
                    groups.setdefault(",".join(k), []).append(
                        dict(bytes=dict(g.bytes), calls=dict(g.calls)))
        out[tag] = dict(loss=loss, tokens=torch.cat(toks, 1).tolist(),
                        forward_s=fwd_s, serve_s=serve_s,
                        forward_flash=fwd_flash, serve_flash=flash,
                        groups=groups)
        del blocks, cache, enc, dec, logits, p
    del params, batch, frames, prompts
    return out


# ---------------------------------------------------------------------------
# the sharded ranks phase's tensor parallelism over model: the dense LMs'
# TP plans over the same (data=2, model=2) world, held to the one-process
# steps the parent runs first (tp_reference.pt)
# ---------------------------------------------------------------------------

TP_DEVICE = "cuda"           # the runs' device
TP_TRAIN = dict(seq=4096, batch=4, steps=2)        # train_4k
TP_PREFILL_BATCH = 2                               # prefill_32k
# smollm's fp32 forward at 4096 tokens, the least the plan's check allows:
# fp32 runs the SIMT route and moves twice the bf16 bytes over gloo
TP_PREFILL_SEQ = {"bf16": 32768, "fp32": 4096}
TP_SERVE = dict(batch=4, steps=16, cache=32768)    # decode_32k
# the prompt prefilled into the cache: danube's longer than its window of
# 4096, so that its decode steps read a window of the cache
TP_PROMPT = {"h2o-danube-1.8b": 4160, "smollm-360m": 2048}
TP_RUNS = (  # arch, run, dtype: danube in bf16, smollm in fp32 (its
    # tokens all equal, its loss at 1e-5; bf16 too took the script past
    # its 1200 s on a slower host)
    ("h2o-danube-1.8b", "train", "bf16"),
    ("h2o-danube-1.8b", "forward", "bf16"),
    ("h2o-danube-1.8b", "serve", "bf16"),
    ("smollm-360m", "forward", "fp32"),
    ("smollm-360m", "serve", "fp32"),
)
TP_PLAN = {"train": "train_4k", "forward": "prefill_32k",
           "serve": "decode_32k"}
TP_FP32_LOSS_BAR = 1e-5      # fp32: a forward's loss vs one process
TP_FP32_BAR = 1e-5           # fp32: the prefill's logits, the cache blocks
TP_BF16_BAR = 5e-2           # bf16: the prefill's logits, the cache blocks


def _tp_key(arch: str, run: str, tag: str) -> str:
    return f"{arch} {run} {tag}"


def _tp_config(torch, arch: str, tag: str):
    """``(cfg, plans)`` of ``arch`` at full width and depth (its config,
    flash on, bf16; ``tag`` fp32: in fp32)."""
    import dataclasses
    import importlib
    mod = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))
    cfg = mod.CFG
    if tag == "fp32":
        cfg = dataclasses.replace(cfg, dtype=torch.float32,
                                  param_dtype=torch.float32)
    return cfg, mod.PLANS


def _tp_setup(torch, arch: str, tag: str):
    """``(cfg, bundle, params)``: the config and bundle of ``arch``
    (:func:`_tp_config`) and its seed-0 bf16 weights on the card (fp32:
    the same weights cast)."""
    from repro_torch.configs import lm_common
    from repro_torch.models import lm as tlm
    cfg, plans = _tp_config(torch, arch, tag)
    bf16, _ = _tp_config(torch, arch, "bf16")
    gen = torch.Generator(device=TP_DEVICE).manual_seed(0)
    with torch.no_grad():
        params = tlm.init_lm(gen, bf16, TP_DEVICE)
    if tag == "fp32":
        params, _ = _fp32(torch, params, bf16)
    return cfg, lm_common.lm_bundle(arch, cfg, plans), params


def _tp_inputs(torch, arch: str, run: str, tag: str, cfg):
    """The run's tokens, drawn on the card from a seed of their own: a
    train or forward batch ``{"tokens": (B, S)}``, or a serve prompt
    ``(B, prompt)``."""
    seed = 1 + TP_RUNS.index((arch, run, tag))
    gen = torch.Generator(device=TP_DEVICE).manual_seed(seed)
    if run == "serve":
        shape = (TP_SERVE["batch"], TP_PROMPT[arch])
    elif run == "train":
        shape = (TP_TRAIN["batch"], TP_TRAIN["seq"])
    else:
        shape = (TP_PREFILL_BATCH, TP_PREFILL_SEQ[tag])
    toks = torch.randint(0, cfg.vocab, shape, generator=gen, device=TP_DEVICE,
                         dtype=torch.int32)
    return toks if run == "serve" else {"tokens": toks}


def _tp_flash_per_layer(cfg, tp: int, index: int) -> int:
    """Flash calls a layer on model rank ``index``: the head runs of its
    q heads (``layers.head_segments``)."""
    from repro_torch.models.layers import head_segments
    a = cfg.attn
    W = a.n_heads * a.head_dim // tp
    c0, c1 = index * W, (index + 1) * W
    return len(head_segments(c0 // a.head_dim, -(-c1 // a.head_dim),
                             a.n_heads // a.n_kv_heads))


def _tp_data_traffic(p_struct, p_specs, sizes) -> dict:
    """A TP train step's data group (FSDP over data): one all-gather and
    one reduce-scatter of the rank's TP blocks of the FSDP leaves, whole
    over data; one fp32 all-reduce of the leaves with no FSDP dim."""
    from repro_torch.runtime import sharding as shard_rules
    split, whole = 0, 0
    for _, s, x in shard_rules.spec_items(p_specs, p_struct):
        fs, tps = shard_rules.split_kinds(s, sizes, "model")
        n = x.numel() // math.prod(c for _, _, c in tps)
        if fs:
            split += n * x.element_size()
        else:
            whole += 4 * n
    return dict(bytes={"all_reduce": whole, "all_gather": split,
                       "reduce_scatter": split},
                calls={"all_reduce": 1, "all_gather": 1,
                       "reduce_scatter": 1})


def _tp_reference(torch, out_dir: str) -> dict:
    """The one-process steps of every TP run on the same weights and
    tokens (``{"data": 1, "model": 1}``), in this process before the ranks
    start: losses, the train step's gradient norms and params after its
    steps, the serve run's prefill logits, greedy tokens and the cache's
    prompt rows; the tensors to ``out_dir/tp_reference.pt`` (host
    memory), the rest returned.  Each run's seconds, peak and flash
    launches."""
    from repro_torch.kernels import launch_counts
    from repro_torch.models import lm as tlm
    from repro_torch.optim import AdamWConfig, adamw_init, global_norm
    from repro_torch.train import steps as tsteps
    from repro_torch.tree import tree_map, tree_paths
    one = {"data": 1, "model": 1}
    meta = lambda t: tree_map(lambda x: x.to("meta") if isinstance(
        x, torch.Tensor) else x, t)
    saved, out = {}, {}
    for arch, run, tag in TP_RUNS:
        key = _tp_key(arch, run, tag)
        cfg, bundle, params = _tp_setup(torch, arch, tag)
        inputs = _tp_inputs(torch, arch, run, tag, cfg)
        plan = bundle.plans[TP_PLAN[run]]
        res = dict(flash=[], seconds=[], peak_bytes=[])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def timed(fn):
            before = launch_counts()["flash_attention"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            res["seconds"].append(time.perf_counter() - t0)
            res["flash"].append(launch_counts()["flash_attention"] - before)
            res["peak_bytes"].append(torch.cuda.max_memory_allocated())
            return r

        if run == "train":
            norms = []
            step, _ = tsteps.build_sharded_train_step(
                bundle.loss_fn, bundle.init_fn, meta(inputs), one, plan,
                AdamWConfig(lr=SHARDED_LR),
                on_grads=lambda g: norms.append(float(global_norm(g))))
            opt = adamw_init(params)
            res["losses"] = []
            for _ in range(TP_TRAIN["steps"]):
                params, opt, loss = timed(lambda: step(params, opt, inputs))
                res["losses"].append(float(loss))
            res["grad_norms"] = norms
            for k, x in tree_paths(params):
                saved[f"{key}|{k}"] = x.cpu()
            del opt, loss
        elif run == "forward":
            step, _ = tsteps.build_forward_step(
                bundle.loss_fn, bundle.init_fn, meta(inputs), one, plan)
            res["loss"] = float(timed(lambda: step(params, inputs)))
        else:
            B, T = TP_SERVE["batch"], TP_SERVE["cache"]
            with torch.inference_mode():
                logits, caches = timed(lambda: tlm.prefill(
                    params, inputs, cfg, T))
                step, _ = tsteps.build_sharded_serve_step(
                    bundle.make_decode_fn(None), bundle.init_fn,
                    meta(caches), torch.empty((B, 1), dtype=torch.int32,
                                              device="meta"), one, plan)
                tok = torch.argmax(logits, -1).to(torch.int32)
                toks = [tok]
                for _ in range(TP_SERVE["steps"]):
                    tok, caches = timed(lambda: step(params, tok, caches))
                    toks.append(tok)
            P = TP_PROMPT[arch]
            saved[f"{key}|logits"] = logits.float().cpu()
            for k in ("k", "v"):
                saved[f"{key}|cache/{k}"] = caches["layers"][k][
                    :, :, :P].cpu()
            res["tokens"] = torch.cat(toks, 1).tolist()
            del caches, logits
        out[key] = res
        del params, step
        release(torch)
    t0 = time.perf_counter()
    torch.save(saved, os.path.join(out_dir, "tp_reference.pt"))
    out["save_s"] = time.perf_counter() - t0
    del saved
    return out


def _tp_rank(torch, grid, out_dir: str) -> dict:
    """The TP runs over the grid, each from the same weights and tokens
    as the reference: the rank's losses, gradient norms, tokens, per step
    seconds, peak, flash launches and groups' bytes, calls and seconds;
    its blocks after the train steps, the prefill's logits and the cache's
    prompt rows against the same views of the reference's, relative
    norms."""
    from repro_torch.kernels import launch_counts
    from repro_torch.models import lm as tlm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import sharding as shard_rules
    from repro_torch.runtime.tensor_parallel import greedy
    from repro_torch.train import steps as tsteps
    from repro_torch.tree import tree_map
    sizes = {"data": SHARDED_DP, "model": SHARDED_PP}
    meta = lambda t: tree_map(lambda x: x.to("meta") if isinstance(
        x, torch.Tensor) else x, t)
    ref = torch.load(os.path.join(out_dir, "tp_reference.pt"), mmap=True)
    out = {}
    for arch, run, tag in TP_RUNS:
        key = _tp_key(arch, run, tag)
        cfg, bundle, params = _tp_setup(torch, arch, tag)
        inputs = _tp_inputs(torch, arch, run, tag, cfg)
        plan = bundle.plans[TP_PLAN[run]]
        res = dict(flash=[], seconds=[], peak_bytes=[], groups=[])

        def timed(step, fn):
            for g in step.comm.groups.values():
                g.reset_bytes()
            before = launch_counts()["flash_attention"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            res["seconds"].append(time.perf_counter() - t0)
            res["flash"].append(launch_counts()["flash_attention"] - before)
            res["peak_bytes"].append(torch.cuda.max_memory_allocated())
            res["groups"].append({",".join(k): dict(
                bytes=dict(g.bytes), calls=dict(g.calls),
                seconds=dict(g.seconds)) for k, g in step.comm.groups.items()})
            return r

        if run == "train":
            step, (p_struct, _, _) = tsteps.build_sharded_train_step(
                bundle.loss_fn, bundle.init_fn, meta(inputs), grid, plan,
                AdamWConfig(lr=SHARDED_LR))
            p_specs = step.in_specs[0]
            blocks = step.shard(params, p_specs)
            del params
            opt = adamw_init(blocks)
            res.update(losses=[], grad_norms=[])
            for _ in range(TP_TRAIN["steps"]):
                blocks, opt, loss = timed(step, lambda: step(blocks, opt,
                                                             inputs))
                res["losses"].append(float(loss))
                res["grad_norms"].append(float(step.grad_norm))
            worst, where = {}, {}
            for k, s, x in shard_rules.spec_items(p_specs, blocks):
                fs, tps = shard_rules.split_kinds(s, sizes, "model")
                kind = "tp" if tps else "fsdp" if fs else "whole"
                want = shard_rules.spec_view(ref[f"{key}|{k}"], s,
                                             grid.coords, sizes).to(TP_DEVICE)
                err = _rel(torch, x, want)
                if kind not in worst or not err <= worst[kind]:
                    worst[kind], where[kind] = err, k
                del want
            res.update(block_rel_err=worst, block_worst_leaf=where,
                       data_traffic=_tp_data_traffic(p_struct, p_specs,
                                                     sizes))
            del blocks, opt, loss
        elif run == "forward":
            step, _ = tsteps.build_forward_step(
                bundle.loss_fn, bundle.init_fn, meta(inputs), grid, plan)
            blocks = step.shard(params, step.in_specs[0])
            del params
            res["loss"] = float(timed(step, lambda: step(blocks, inputs)))
            del blocks
        else:
            B, T, P = TP_SERVE["batch"], TP_SERVE["cache"], TP_PROMPT[arch]
            struct = tlm.init_caches(cfg, B, T, device="meta")
            step, _ = tsteps.build_sharded_serve_step(
                bundle.make_decode_fn(None), bundle.init_fn, struct,
                torch.empty((B, 1), dtype=torch.int32, device="meta"), grid,
                plan)
            p_specs, c_specs = step.in_specs[0], step.in_specs[2]
            blocks = step.shard(params, p_specs)
            del params
            rows = step.local(inputs, step.in_specs[1])
            caches = shard_rules.spec_map(
                lambda s, x: torch.zeros(shard_rules.spec_view(
                    x, s, grid.coords, sizes).shape, dtype=x.dtype,
                    device=TP_DEVICE) if isinstance(x, torch.Tensor) else x,
                c_specs, struct)
            tp = step.tp
            with torch.inference_mode():
                t0 = time.perf_counter()
                logits, caches = tlm.prefill(
                    step.gather(blocks, p_specs), rows, cfg, T,
                    caches=caches, tp=tp)
                tok = step.gather_rows(greedy(logits, tp))
                torch.cuda.synchronize()
                res["prefill_s"] = time.perf_counter() - t0
                want = shard_rules.spec_view(
                    ref[f"{key}|logits"], shard_rules.Spec(["data"]),
                    grid.coords, sizes)[..., logits.start:logits.start
                                        + logits.local.shape[-1]]
                res["prefill_logits_rel_err"] = _rel(
                    torch, logits.local, want.to(TP_DEVICE))
                toks = [tok]
                for _ in range(TP_SERVE["steps"]):
                    mine, caches = timed(step, lambda: step(blocks, tok,
                                                            caches))
                    tok = step.gather_rows(mine)
                    toks.append(tok)
            res["tokens"] = torch.cat(toks, 1).tolist()
            errs = {}
            for k in ("k", "v"):
                spec = c_specs["layers"][k]
                want = shard_rules.spec_view(ref[f"{key}|cache/{k}"], spec,
                                             grid.coords, sizes)
                errs[k] = _rel(torch, caches["layers"][k][:, :, :P],
                               want.to(TP_DEVICE))
            res["cache_rel_err"] = errs
            res["cache_block_shape"] = list(caches["layers"]["k"].shape)
            del blocks, caches, logits
        out[key] = res
        del step
        release(torch)
    del ref
    return out


def _tp_check(torch, rec: dict, docs: list, ref: dict, smi_line: str) -> None:
    """Hold the ranks' TP runs to the one-process references: every rank
    alike; train (bf16): the losses (step 0 at ``SHARDED_LOSS0_BAR``, then
    ``SHARDED_BAR``), the step-0 norm and every block after the last step
    (TP blocks, FSDP blocks, whole leaves) at ``SHARDED_BAR``; forward:
    the loss at ``TP_FP32_LOSS_BAR`` (fp32) or ``SHARDED_LOSS0_BAR``
    (bf16); serve: the prefill's logits and the cache's prompt rows (each
    rank's block) at ``TP_FP32_BAR`` / ``TP_BF16_BAR``, fp32 tokens all
    equal (bf16: the share equal printed); each step's model group bytes
    and calls = ``lm_traffic``, the train step's data group =
    ``_tp_data_traffic``; flash launches a layer's head runs times the
    layers (a train step twice: remat)."""
    from repro_torch.runtime.tensor_parallel import lm_traffic
    what = "sharded ranks tp"
    summary = {}
    for arch, run, tag in TP_RUNS:
        key = _tp_key(arch, run, tag)
        one = ref[key]
        got = {d["rank"]: d["tp"][key] for d in docs}
        cfg, _ = _tp_config(torch, arch, tag)
        e = 4 if tag == "fp32" else 2
        B = (TP_TRAIN["batch"] if run == "train" else TP_SERVE["batch"]
             if run == "serve" else TP_PREFILL_BATCH) // SHARDED_DP
        S = TP_TRAIN["seq"] if run == "train" else TP_PREFILL_SEQ[tag]
        traffic = lm_traffic(cfg, run, B=B, S=S, tp=SHARDED_PP, esize=e)
        for r, g in got.items():
            m = r % SHARDED_PP
            flash = (_tp_flash_per_layer(cfg, SHARDED_PP, m) * cfg.n_layers
                     * (2 if run == "train" else 1))
            if any(n != flash for n in g["flash"]):
                fail(f"{what}: {key} rank {r} flash a step {g['flash']}, "
                     f"want {flash}")
            for s, st in enumerate(g["groups"]):
                mg = {k: st["model"][k] for k in ("bytes", "calls")}
                if mg != traffic:
                    fail(f"{what}: {key} rank {r} step {s} model group "
                         f"{mg}, want {traffic}")
                if run == "train":
                    dg = {k: st["data"][k] for k in ("bytes", "calls")}
                    if dg != g["data_traffic"]:
                        fail(f"{what}: {key} rank {r} step {s} data group "
                             f"{dg}, want {g['data_traffic']}")
        if run == "train":
            losses = [g["losses"] for g in got.values()]
            if any(x != losses[0] for x in losses):
                fail(f"{what}: {key} ranks disagree on the losses {losses}")
            rel = [abs(x - w) / abs(w)
                   for x, w in zip(losses[0], one["losses"])]
            bars = ([SHARDED_LOSS0_BAR]
                    + [SHARDED_BAR] * (TP_TRAIN["steps"] - 1))
            if not all(math.isfinite(x) for x in losses[0]) or not all(
                    x <= b for x, b in zip(rel, bars)):
                fail(f"{what}: {key} losses {losses[0]} vs one process "
                     f"{one['losses']} (relative {rel}, bars {bars})")
            norm_rel = max(abs(g["grad_norms"][0] - one["grad_norms"][0])
                           / one["grad_norms"][0] for g in got.values())
            if not norm_rel <= SHARDED_BAR:
                fail(f"{what}: {key} step-0 norms "
                     f"{[g['grad_norms'][0] for g in got.values()]} vs "
                     f"{one['grad_norms'][0]} (relative {norm_rel:.3e})")
            blocks = {r: g["block_rel_err"] for r, g in got.items()}
            worst = max(v for b in blocks.values() for v in b.values())
            if not worst <= SHARDED_BAR:
                fail(f"{what}: {key} blocks vs the reference's {blocks} at "
                     f"{[g['block_worst_leaf'] for g in got.values()]}")
            held = dict(losses=losses[0], loss_rel_err=rel,
                        first_norm_rel_err=norm_rel, block_rel_err=blocks)
        elif run == "forward":
            losses = [g["loss"] for g in got.values()]
            rel = max(abs(x - one["loss"]) / abs(one["loss"])
                      for x in losses)
            bar = TP_FP32_LOSS_BAR if tag == "fp32" else SHARDED_LOSS0_BAR
            if not (all(math.isfinite(x) for x in losses) and rel <= bar):
                fail(f"{what}: {key} losses {losses} vs one process "
                     f"{one['loss']} (relative {rel:.3e} > {bar})")
            held = dict(losses=losses, loss_rel_err=rel, bar=bar)
        else:
            bar = TP_FP32_BAR if tag == "fp32" else TP_BF16_BAR
            errs = {r: dict(logits=g["prefill_logits_rel_err"],
                            **g["cache_rel_err"]) for r, g in got.items()}
            worst = max(v for x in errs.values() for v in x.values())
            if not worst <= bar:
                fail(f"{what}: {key} prefill logits and cache blocks vs "
                     f"the reference's {errs} (bar {bar})")
            want = one["tokens"]
            equal = {r: sum(a == b for x, y in zip(g["tokens"], want)
                            for a, b in zip(x, y)) / sum(map(len, want))
                     for r, g in got.items()}
            if tag == "fp32" and any(v != 1.0 for v in equal.values()):
                fail(f"{what}: {key} fp32 tokens differ from one process's "
                     f"(share equal {equal})")
            held = dict(rel_err=errs, bar=bar, tokens_equal=equal,
                        cache_block_shape={r: g["cache_block_shape"]
                                           for r, g in got.items()})
        secs = {r: [round(x, 3) for x in g["seconds"]]
                for r, g in got.items()}
        peaks = {r: [round(x / 1e9, 3) for x in g["peak_bytes"]]
                 for r, g in got.items()}
        model_s = {r: [round(sum(st["model"]["seconds"].values()), 3)
                       for st in g["groups"]] for r, g in got.items()}
        summary[key] = dict(held=held, traffic=traffic, step_seconds=secs,
                            peak_gb=peaks, model_group_seconds=model_s,
                            flash_per_step={r: g["flash"][0]
                                            for r, g in got.items()},
                            one_process=one)
        log(f"[sharded ranks tp] {key} ({TP_PLAN[run]}, B={B} a replica"
            f"{'' if run == 'serve' else f', S={S}'}): held {held}")
        log(f"[sharded ranks tp] {key}: model group a step {traffic} = "
            f"the arithmetic; its seconds a step {model_s}; step s {secs}; "
            f"peak GB {peaks}; flash a step "
            f"{summary[key]['flash_per_step']}; one process: step s "
            f"{[round(x, 3) for x in one['seconds']]}, peak GB "
            f"{[round(x / 1e9, 3) for x in one['peak_bytes']]}, flash "
            f"{one['flash'][:2]}; {smi_line}")
    rec["sharded_ranks"]["tp"] = summary



def sharded_rank_worker(rank: int, port: int, out_dir: str) -> None:
    """One rank of the ``sharded ranks`` phase (``chip_smoke.py
    --sharded-rank R --port P --out DIR``): the UNet's ``SHARDED_STEPS``
    steps through ``build_sharded_train_step`` over the grid from the
    seed-0 weights, batch and draws (each step's loss, gradient norm over
    the grid, seconds, peak, launches and FSDP group traffic; after the
    last step every block against the one-process reference's same block,
    read from DIR/reference.pt), then ``_whisper_runs`` over the grid;
    all of it to DIR/rank<R>.json."""
    import datetime

    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.sdv2_unet import PLANS
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.mesh import make_rank_grid
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import sharding as shard_rules
    from repro_torch.train import steps as tsteps
    from repro_torch.tree import tree_map, tree_paths

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank,
                            world_size=SHARDED_DP * SHARDED_PP,
                            timeout=datetime.timedelta(seconds=600))
    grid = make_rank_grid(SHARDED_PP, dp=SHARDED_DP)
    loss_fn, init_fn, cfg = _sharded_unet(torch)
    params, batch, draws, digest = _sharded_unet_inputs(torch, init_fn, cfg)
    step, _ = tsteps.build_sharded_train_step(
        loss_fn, init_fn, tree_map(lambda x: x.to("meta"), batch), grid,
        PLANS["train_4k"], AdamWConfig(lr=SHARDED_LR))
    p_specs = step.in_specs[0]
    blocks = step.shard(params, p_specs)
    # the leaves drawn as zeros (biases): their first AdamW updates go as
    # the sign of the gradient, so their blocks are held entry by entry
    zero_init = {k for k, x in tree_paths(params) if not bool(x.any())}
    del params
    torch.cuda.empty_cache()
    opt = adamw_init(blocks)
    init_peak = torch.cuda.max_memory_allocated()
    steps = []
    for i in range(SHARDED_STEPS):
        for g in (step.comm.groups.values()):
            g.reset_bytes()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        t0 = time.perf_counter()
        blocks, opt, loss = step(blocks, opt, batch, **draws[i])
        torch.cuda.synchronize()
        after = launch_counts()
        steps.append(dict(
            loss=float(loss), norm=float(step.grad_norm),
            seconds=time.perf_counter() - t0,
            peak_bytes=torch.cuda.max_memory_allocated(),
            launches={k: v - before[k] for k, v in after.items()},
            groups={",".join(k): dict(bytes=dict(g.bytes),
                                      calls=dict(g.calls),
                                      seconds=dict(g.seconds))
                    for k, g in step.comm.groups.items()}))
        del loss
    # every block after the last step against the reference's same block
    # (written by the parent before the ranks started)
    ref = torch.load(os.path.join(out_dir, "reference.pt"), mmap=True)
    sizes = {"data": SHARDED_DP, "model": SHARDED_PP}
    worst, where = {}, {}
    for k, spec, x in shard_rules.spec_items(p_specs, blocks):
        want = shard_rules.spec_view(ref[k], spec, grid.coords, sizes).to(
            "cuda")
        kind = "sharded" if shard_rules.sharded_dims(spec, sizes) else \
            "whole"
        if k in zero_init:
            # the share of entries more than one step's lr off
            err = float(((x.float() - want.float()).abs()
                         > SHARDED_LR).float().mean())
            kind += " zero-init off-lr share"
        else:
            err = _rel(torch, x, want)
            kind += " rel"
        if kind not in worst or not err <= worst[kind]:
            worst[kind], where[kind] = err, k
        del want, x
    del ref, blocks, opt, step, batch, draws
    torch.cuda.empty_cache()
    unet_launches = launch_counts()
    whisper = _whisper_runs(torch, grid)
    release(torch)
    tp = _tp_rank(torch, grid, out_dir)
    doc = dict(rank=rank, coords=grid.coords, digest=digest,
               init_peak_bytes=init_peak, steps=steps,
               block_rel_err=worst, block_worst_leaf=where,
               unet_launches=unet_launches, whisper=whisper, tp=tp,
               launches=launch_counts())
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(doc, f)
    dist.barrier()
    dist.destroy_process_group()


def _sharded_traffic(p_struct, p_specs, sizes) -> dict:
    """The UNet step's FSDP group traffic from the specs and the leaves'
    shapes: one all-gather and one reduce-scatter a dtype of the split
    leaves' whole bytes (the gathered tensors; gloo's scatter moves the
    gradients' dtype), one fp32 all-reduce of the whole leaves' gradients
    and one of the loss and the squared norm (8 bytes)."""
    from repro_torch.runtime import sharding as shard_rules
    split, whole = {}, 0
    for _, s, x in shard_rules.spec_items(p_specs, p_struct):
        if shard_rules.sharded_dims(s, sizes):
            split[x.dtype] = split.get(x.dtype, 0) + \
                x.numel() * x.element_size()
        else:
            whole += 4 * x.numel()
    nb = sum(split.values())
    return dict(bytes={"all_reduce": whole + 8, "all_gather": nb,
                       "reduce_scatter": nb},
                calls={"all_reduce": 2, "all_gather": len(split),
                       "reduce_scatter": len(split)})


def sharded_ranks_phase(torch, rec, smi_line: str) -> dict:
    """The sharded strategy over four rank processes on the one card (gloo,
    staged through pinned host memory), a ``(data=2, model=2)`` grid.

    The SDv2 UNet at full width (1,839,817,728 params, bf16, the norm
    leaves fp32, flash on), its own ``train_4k`` plan, global batch
    ``SHARDED_BATCH`` (8 rows a data replica, computed on both model ranks
    of it), ``SHARDED_STEPS`` AdamW steps, held to the one-process
    ``build_sharded_train_step`` on the same weights, batch and draws (run
    here first, and freed before the ranks start): every rank's loss
    equal, step 0's at ``SHARDED_LOSS0_BAR`` and step 1's at
    ``SHARDED_BAR``, the step-0 gradient norm over the grid at
    ``SHARDED_BAR``, every rank's gradient finite, and after the last step
    each rank's block of every sharded leaf within ``SHARDED_BAR``
    (relative norm) of the reference's same block (a leaf drawn as zeros:
    at most ``SHARDED_BAR`` of its entries more than lr off; the whole
    leaves' worst printed); flash ``UNET_FLASH_PER_STEP`` times a
    step on every rank; each rank's FSDP group traffic equal to
    ``_sharded_traffic``.  whisper-base at full width on its
    ``prefill_32k`` and ``decode_32k`` plans: in fp32 the forward's loss
    at ``SHARDED_WH_BAR`` of the one-process step's and every greedy token
    equal (the bf16 ones printed).  Returns the ranks' launches."""
    import shutil
    import socket

    from repro_torch.configs.sdv2_unet import PLANS
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.optim import AdamWConfig, adamw_init, global_norm
    from repro_torch.train import steps as tsteps
    from repro_torch.tree import tree_map, tree_paths

    t_phase = time.perf_counter()
    what = "sharded ranks"
    out_dir = os.path.join(ROOT, "build", "chip_smoke_sharded")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)

    # the one-process reference on the card
    loss_fn, init_fn, cfg = _sharded_unet(torch)
    params, batch, draws, digest = _sharded_unet_inputs(torch, init_fn, cfg)
    n_params = sum(x.numel() for x in _leaves(params))
    norms = []
    ref_step, (p_struct, _, _) = tsteps.build_sharded_train_step(
        loss_fn, init_fn, tree_map(lambda x: x.to("meta"), batch),
        {"data": 1, "model": 1}, PLANS["train_4k"],
        AdamWConfig(lr=SHARDED_LR),
        on_grads=lambda g: norms.append(float(global_norm(g))))
    opt = adamw_init(params)
    ref = dict(losses=[], seconds=[], peak_bytes=[], flash=[])
    for i in range(SHARDED_STEPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()["flash_attention"]
        t0 = time.perf_counter()
        params, opt, loss = ref_step(params, opt, batch, **draws[i])
        torch.cuda.synchronize()
        ref["seconds"].append(time.perf_counter() - t0)
        ref["losses"].append(float(loss))
        ref["peak_bytes"].append(torch.cuda.max_memory_allocated())
        ref["flash"].append(launch_counts()["flash_attention"] - before)
    ref["grad_norms"] = norms
    t0 = time.perf_counter()
    torch.save({k: x.cpu() for k, x in tree_paths(params)},
               os.path.join(out_dir, "reference.pt"))
    ref["save_s"] = time.perf_counter() - t0
    del params, opt, batch, draws, loss
    one_whisper = _whisper_runs(torch, {"data": 1, "model": 1})
    release(torch)
    tp_ref = _tp_reference(torch, out_dir)
    left = release(torch)
    if left >= 1e9:
        fail(f"{what}: {left / 1e9:.2f} GB still allocated before the ranks")
    ref_s = time.perf_counter() - t_phase

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, REPRO_TORCH_NO_BUILD="1")
    world = SHARDED_DP * SHARDED_PP
    logs = [open(os.path.join(OUT_DIR, f"sharded_ranks.r{r}.log"), "w")
            for r in range(world)]
    reset_launch_counts()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--sharded-rank", str(r),
         "--port", str(port), "--out", out_dir], env=env, cwd=ROOT,
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    t0 = time.perf_counter()
    try:
        codes = [p.wait(timeout=SHARDED_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    if any(codes):
        tails = []
        for r in range(world):
            with open(os.path.join(OUT_DIR, f"sharded_ranks.r{r}.log")) as f:
                tails.append(f"rank {r}:\n{f.read()[-2000:]}")
        fail(f"{what}: rank exit codes {codes}\n" + "\n".join(tails))
    docs = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            docs.append(json.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)

    # the UNet: the reference's weights, batch and draws
    for d in docs:
        if d["digest"] != digest:
            fail(f"{what}: rank {d['rank']} drew {d['digest']}, the "
                 f"reference {digest}")
    losses = [[st["loss"] for st in d["steps"]] for d in docs]
    if any(x != losses[0] for x in losses):
        fail(f"{what}: the ranks disagree on the losses {losses}")
    losses = losses[0]
    rel = [abs(x - r) / abs(r) for x, r in zip(losses, ref["losses"])]
    bars = [SHARDED_LOSS0_BAR] + [SHARDED_BAR] * (SHARDED_STEPS - 1)
    if not all(math.isfinite(x) for x in losses) or \
            not all(e <= b for e, b in zip(rel, bars)):
        fail(f"{what}: losses {losses} vs the one-process step's "
             f"{ref['losses']} (relative {rel}, bars {bars})")
    norms = {d["rank"]: [st["norm"] for st in d["steps"]] for d in docs}
    if not all(math.isfinite(x) for n in norms.values() for x in n):
        fail(f"{what}: gradient norms over the grid {norms}: a rank's "
             "gradient is not finite")
    norm_rel = {r: abs(n[0] - ref["grad_norms"][0]) / ref["grad_norms"][0]
                for r, n in norms.items()}
    if not max(norm_rel.values()) <= SHARDED_BAR:
        fail(f"{what}: step-0 gradient norms over the grid {norms} vs "
             f"{ref['grad_norms'][0]} (relative {norm_rel}, bar "
             f"{SHARDED_BAR})")
    # the sharded leaves' blocks are held (an update applied to another
    # block, or to none, shows there): a leaf drawn from a distribution by
    # its relative norm; a leaf drawn as zeros (a bias), whose first AdamW
    # updates go as the sign of its gradient (an entry near zero flips
    # with bf16 sums over other rows, 2 lr apart), by the share of its
    # entries more than lr off, which an update to another block or to
    # none puts near 1.  The whole leaves, updated alike on every rank
    # from one all-reduced gradient, are printed
    blocks = {d["rank"]: d["block_rel_err"] for d in docs}
    held = [v for b in blocks.values() for k, v in b.items()
            if k.startswith("sharded")]
    if not held or not max(held) <= SHARDED_BAR:
        fail(f"{what}: blocks after step {SHARDED_STEPS - 1} vs the "
             f"reference's (relative norm) {blocks} at "
             f"{[d['block_worst_leaf'] for d in docs]}, bar {SHARDED_BAR}")
    flash = [sum(d["steps"][s]["launches"]["flash_attention"] for d in docs)
             for s in range(SHARDED_STEPS)]
    if any(n != world * UNET_FLASH_PER_STEP for n in flash):
        fail(f"{what}: flash launches a step over the ranks {flash}, want "
             f"{world} x {UNET_FLASH_PER_STEP}")
    sizes = {"data": SHARDED_DP, "model": SHARDED_PP}
    fsdp = ",".join(a for a in PLANS["train_4k"].fsdp_axes if a in sizes)
    traffic = _sharded_traffic(
        p_struct, tsteps.param_specs_for(p_struct, sizes, PLANS["train_4k"]),
        sizes)
    for d in docs:
        for s, st in enumerate(d["steps"]):
            g = st["groups"]
            if set(g) != {fsdp} or {k: g[fsdp][k] for k in
                                    ("bytes", "calls")} != traffic:
                fail(f"{what}: rank {d['rank']} step {s} groups {g}, want "
                     f"{fsdp}: {traffic}")

    # whisper: fp32 held to the one-process steps, bf16 printed
    for d in docs:
        w = d["whisper"]
        got = w["fp32"]
        e = abs(got["loss"] - one_whisper["fp32"]["loss"]) / abs(
            one_whisper["fp32"]["loss"])
        if not e <= SHARDED_WH_BAR:
            fail(f"{what}: rank {d['rank']} whisper fp32 forward loss "
                 f"{got['loss']} vs one process {one_whisper['fp32']['loss']}"
                 f" (relative {e:.3e} > {SHARDED_WH_BAR})")
        if got["tokens"] != one_whisper["fp32"]["tokens"]:
            fail(f"{what}: rank {d['rank']} whisper fp32 tokens differ from "
                 "the one-process serve step's")
        for tag in ("bf16", "fp32"):
            if w[tag]["forward_flash"] != WHISPER_FLASH_PER_STEP or any(
                    n != WHISPER_SERVE_FLASH for n in w[tag]["serve_flash"]):
                fail(f"{what}: rank {d['rank']} whisper {tag} flash "
                     f"{w[tag]['forward_flash']} a forward, "
                     f"{w[tag]['serve_flash']} a serve step")
    launched = {k: sum(d["launches"][k] for d in docs)
                for k in docs[0]["launches"]}
    want_bf16 = list(itertools.chain(*one_whisper["bf16"]["tokens"]))
    bf16_equal = [sum(a == b for a, b in zip(itertools.chain(
        *d["whisper"]["bf16"]["tokens"]), want_bf16)) / len(want_bf16)
        for d in docs]
    secs = {d["rank"]: [round(st["seconds"], 3) for st in d["steps"]]
            for d in docs}
    peaks = {d["rank"]: [st["peak_bytes"] for st in d["steps"]]
             for d in docs}
    gloo_s = {d["rank"]: [{k: round(v, 3) for k, v in
                           st["groups"][fsdp]["seconds"].items()}
                          for st in d["steps"]] for d in docs}
    rec["sharded_ranks"] = dict(
        card=smi_line, dp=SHARDED_DP, pp=SHARDED_PP, params=n_params,
        global_batch=SHARDED_BATCH, reference=ref, reference_s=ref_s,
        ranks_wall_s=wall, losses=losses, loss_rel_err=rel,
        grad_norms=norms, first_grad_norm_rel_err=norm_rel,
        block_rel_err=blocks, step_seconds=secs, peak_bytes=peaks,
        init_peak_bytes={d["rank"]: d["init_peak_bytes"] for d in docs},
        traffic=traffic, gloo_seconds=gloo_s, flash_per_step=flash,
        whisper={d["rank"]: d["whisper"] for d in docs},
        whisper_one_process=one_whisper, whisper_bf16_tokens_equal=bf16_equal,
        launches=launched)
    _tp_check(torch, rec, docs, tp_ref, smi_line)
    log(f"[sharded ranks] sdv2-unet {n_params} params, bf16, flash; "
        f"train_4k (FSDP {fsdp}, batch over data), global batch "
        f"{SHARDED_BATCH}; four ranks on one card (gloo, staged); ranks "
        f"{wall:.1f} s; {smi_line}")
    log(f"[sharded ranks] losses {losses} vs one process {ref['losses']} "
        f"(relative {[f'{x:.2e}' for x in rel]}, bars {bars}); step-0 norm "
        f"over the grid {norms[0][0]!r} vs {ref['grad_norms'][0]!r} (relative"
        f" {max(norm_rel.values()):.2e}); blocks after step "
        f"{SHARDED_STEPS - 1} vs the reference's: {blocks}")
    log(f"[sharded ranks] one process: step s "
        f"{[round(x, 3) for x in ref['seconds']]}, peak GB "
        f"{[round(x / 1e9, 3) for x in ref['peak_bytes']]}, flash a step "
        f"{ref['flash']}; reference saved in {ref['save_s']:.1f} s")
    log(f"[sharded ranks] FSDP group ({fsdp}) a step, each rank: "
        f"{traffic} = the arithmetic of the specs; gloo seconds {gloo_s}")
    log(f"[sharded ranks] flash a step over the ranks {flash}")
    for d in docs:
        log(f"[sharded ranks] rank {d['rank']} {d['coords']}: step s "
            f"{secs[d['rank']]}; peak GB "
            f"{[round(x / 1e9, 3) for x in peaks[d['rank']]]} (set-up "
            f"{d['init_peak_bytes'] / 1e9:.3f})")
    w0 = docs[0]["whisper"]
    log(f"[sharded ranks] whisper-base prefill_32k B={WHISPER_BATCH}: fp32 "
        f"loss {w0['fp32']['loss']!r} vs one process "
        f"{one_whisper['fp32']['loss']!r}; bf16 {w0['bf16']['loss']!r} vs "
        f"{one_whisper['bf16']['loss']!r}; decode_32k "
        f"{SHARDED_SERVE_STEPS} greedy steps B={SERVE_WHISPER['batch']}: "
        f"fp32 tokens equal on every rank; bf16 tokens equal to one "
        f"process's {bf16_equal}; forward s {w0['bf16']['forward_s']:.3f}, "
        f"serve s {w0['bf16']['serve_s']:.3f} (bf16); groups "
        f"{w0['bf16']['groups']}")
    log(f"[sharded ranks] phase {time.perf_counter() - t_phase:.1f} s")
    return launched


# ---------------------------------------------------------------------------
# phase 13: hybrid -- the tuner's N=4 plan for UViT-H (P=2, G=2, V=2, M=2):
# two data replicas of a 2-device pipeline, four ranks on the one card, at
# ZeRO-1 and ZeRO-2
# ---------------------------------------------------------------------------

HYBRID_DP, HYBRID_PP, HYBRID_V, HYBRID_M = 2, 2, 2, 2
HYBRID_STEPS = 3
# UViT-H cut to 8 of its 32 blocks in the hybrid, rank checkpoint and
# supervisor phases: their gloo collectives and checkpoint bytes scale with
# the params, and these three phases took most of the script's time (16
# blocks until the sharded ranks phase came; 32 before that)
HYBRID_LAYERS = 8
HYBRID_ZERO = (1, 2)
# the plan in one process (one data replica), then as the ranks run it
HYBRID_ONE_ARGV = ["--arch", "uvit-h", "--pipeline", "--pp", str(HYBRID_PP),
                   "--interleave", str(HYBRID_V), "--microbatches",
                   str(HYBRID_M), "--global-batch", str(PLAN_BATCH),
                   "--steps", str(HYBRID_STEPS), "--log-every", "1",
                   "--layers", str(HYBRID_LAYERS), "--device", "cuda"]
HYBRID_ARGV = HYBRID_ONE_ARGV + ["--dp", str(HYBRID_DP), "--ring", "gloo"]
HYBRID_LOSS_BAR = 1e-2          # step 0 against the one-process run, bf16
HYBRID_FINGERPRINT_BAR = 2e-2   # ||err|| / ||g|| per gradient leaf, bf16
HYBRID_ZERO_BAR = 1e-3          # ZeRO-1 against ZeRO-2, steps 0-2


def _hybrid_plan(zero: int):
    """The trainer's plan of ``HYBRID_ARGV`` at ``zero`` (its graph at the
    batch of a microbatch, as ``train.build_trainer`` builds it), and the
    model's config."""
    from repro_torch.core.hw import H100_SXM
    from repro_torch.launch import train as train_mod
    from repro_torch.models.diffusion import uvit_pipeline_graph
    from repro_torch.runtime.adapters import model_fns
    from repro_torch.runtime.compile import auto_pipeline
    cfg = train_mod._model_config(train_mod._parse_args(HYBRID_ARGV))
    graph = uvit_pipeline_graph(cfg, batch=PLAN_BATCH // HYBRID_M,
                                hw=H100_SXM)
    return auto_pipeline(
        graph, model_fns(cfg, "uvit"), HYBRID_DP * HYBRID_PP, hw=H100_SXM,
        pipeline_devices=HYBRID_PP, microbatches=HYBRID_M,
        interleave=HYBRID_V, dp_size=HYBRID_DP, zero_stage=zero,
        wire_dtype="bfloat16"), cfg


def hybrid_bytes(cp, pipe: int, step: bool) -> tuple[dict, dict]:
    """The data group's bytes and calls of pipeline index ``pipe`` in one
    forward+backward (``step`` False: the probe) or one training step,
    from the plan's step tables and the leaves' shapes (drawn on the
    ``meta`` device): one fp32 all-reduce each of the loss, the edge
    gradients and, per stack, the stage gradients ZeRO keeps whole; ZeRO-1
    reduce-scatters each stack's sharded gradients in one call and, in a
    step, all-gathers their updated shards in one call; ZeRO-2
    all-gathers the sharded leaves of the slot each step of the walk
    runs, in one call, in the forward and again in the recompute, and
    reduce-scatters their gradients once; gathers and gloo's
    reduce-scatters move the params' dtype (bf16); a step adds the grid's
    norm and finite flag (8 bytes, one call)."""
    import torch as t

    from repro_torch.runtime.sharding import leaf_dims
    from repro_torch.tree import tree_leaves
    z = cp.pcfg.zero_stage
    stacks, edge = cp.model_fns.split_blocks(cp.model_fns.init_fn(
        t.Generator().manual_seed(0), "meta"))
    rows = cp.layout.split(tuple(stacks), pipe)
    edge_n = [x.numel() for x in tree_leaves(edge)]
    nb = {"all_reduce": 4 * (1 + sum(edge_n)) + (8 if step else 0),
          "all_gather": 0, "reduce_scatter": 0}
    calls = {"all_reduce": 2 + (1 if step else 0), "all_gather": 0,
             "reduce_scatter": 0}
    sel = cp.step_tables().sel[pipe]
    for i, (st, ds) in enumerate(zip(rows, cp.zero_dims())):
        whole = sharded = slot = 0    # slot: sharded bytes of a [pad, ...]
        for x, d in leaf_dims(st, ds):
            if d < 0:
                whole += 4 * x.numel()
            elif z == 1:
                sharded += x.element_size() * x.numel()
            else:
                slot += x.element_size() * x[0].numel()
        if whole:
            nb["all_reduce"] += whole
            calls["all_reduce"] += 1
        if sharded:
            nb["reduce_scatter"] += sharded
            calls["reduce_scatter"] += 1
            if step:
                nb["all_gather"] += sharded
                calls["all_gather"] += 1
        if slot:
            runs = int((sel == i + 1).sum())
            nb["all_gather"] += 2 * runs * slot
            nb["reduce_scatter"] += runs * slot
            calls["all_gather"] += 2 * runs
            calls["reduce_scatter"] += runs
    return nb, calls


def _hybrid_reference() -> dict:
    """``HYBRID_ONE_ARGV`` through the trainer in this process: the ranks'
    plan (P, V, M and the trainer's cuts) with one data replica on the
    whole global batch.  Its cuts, losses, step 0's gradient fingerprints
    before its update, the ring's bytes a step and the kernel launches a
    step: what every data replica of the ranks is held to."""
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import train as train_mod
    from repro_torch.runtime import pipeline as rp
    fingerprints = {}

    def on_grads(step, grads):
        if step == 0:
            fingerprints.update(train_mod.grad_fingerprints(grads))

    before = launch_counts()
    rp.reset_hop_bytes()
    res = train_mod.run(train_mod._parse_args(HYBRID_ONE_ARGV),
                        on_grads=on_grads)
    hops = rp.hop_bytes()
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    out = dict(cuts=list(res.compiled.partition.cuts),
               losses=[res.losses[s] for s in sorted(res.losses)],
               fingerprints=fingerprints,
               hop_bytes_per_step={k: v / HYBRID_STEPS
                                   for k, v in hops.items()},
               launches=launched,
               launches_per_step={k: v / HYBRID_STEPS
                                  for k, v in launched.items()},
               peak_bytes=res.peak_bytes)
    del res
    return out


def _hybrid_run(zero: int, out_dir: str, env: dict,
                extra: list = ()) -> tuple[list, float]:
    """One torchrun of ``HYBRID_ARGV`` at ``zero`` (and ``extra``): the
    four ranks' report documents and the wall seconds."""
    import shutil
    shutil.rmtree(out_dir, ignore_errors=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(HYBRID_DP * HYBRID_PP), "-m",
           "repro_torch.launch.train", *HYBRID_ARGV, "--zero-stage",
           str(zero), "--rank-report", out_dir, *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=RANKS_TIMEOUT)
    wall = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, f"hybrid_zero{zero}.log"), "w") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode != 0:
        fail(f"hybrid ZeRO-{zero}: torchrun exited {proc.returncode}:\n"
             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    docs = []
    for r in range(HYBRID_DP * HYBRID_PP):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            docs.append(json.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)
    return docs, wall


def hybrid_phase(torch, rec, smi_line: str, ckdir: str) -> tuple:
    """Four ranks of ``repro_torch.launch.train`` on the one card over the
    staged gloo ring and data group: the tuner's own N=4 plan for UViT-H
    at full width, ``HYBRID_LAYERS`` of its 32 blocks (P=2 pipeline
    devices, G=2 data replicas, V=2, M=2), global batch ``PLAN_BATCH``,
    bf16, at ZeRO-1 and then ZeRO-2, each ``HYBRID_STEPS`` AdamW steps
    (``--rank-report``; the probe is the first step's forward+backward,
    read before its update).  ZeRO-0 is left out: the phase holds the two
    sharded stages (Eq. 14 of each printed).  First the same plan in one
    process
    (:func:`_hybrid_reference`).
    Held: P, G, V and M are the tuner's N=4 choice; the ranks' cuts (the
    trainer's own partition on roofline costs, which the tuner's on the
    plan phase's measured costs may differ from by a block) are the
    one-process run's; every rank's step-0 loss to that run's at
    ``HYBRID_LOSS_BAR``; every gradient leaf's fingerprint, gathered
    whole, to its step 0 at ``HYBRID_FINGERPRINT_BAR``; the ZeRO-1 and
    ZeRO-2 losses of steps 0-2 within ``HYBRID_ZERO_BAR``; the data
    group's bytes and calls, by collective, of the probe and of every
    step, to their arithmetic (:func:`hybrid_bytes`), exactly; the ring's
    bytes, each direction summed over the ranks, to the one-process run's
    ``HOP_BYTES`` live count a step, exactly; the flash and skip launches
    of the probe, summed over the ranks, to twice the one-process run's a
    step (each replica runs every block call); each rank's ZeRO-2 peak
    below its ZeRO-1 peak.  Printed: peaks beside Eq. 14's per-device
    prediction at each stage, step seconds, the collectives' host seconds.
    The ZeRO-2 run also saves a checkpoint into ``ckdir`` for the ``rank
    checkpoint`` phase (:data:`RANK_CKPT_SAVE`: a save of step 3, then
    step 3, then a stop without a final save).  Returns the launches by
    path, the ranks' own (``hybrid``) and the one-process reference's
    (``hybrid reference``), and the ZeRO-2 ranks' report documents."""
    from repro_torch.core.comm_model import WIRE_BYTES
    from repro_torch.core.hw import H100_SXM
    from repro_torch.core.tuner import peak_memory, profile_partition
    from repro_torch.models.diffusion import uvit_pipeline_graph

    t_phase = time.perf_counter()
    choice = rec["plan"]["uvit-h"]["N4"]["choice"]
    want = dict(P=HYBRID_PP, G=HYBRID_DP, V=HYBRID_V, M=HYBRID_M)
    if {k: choice[k] for k in want} != want:
        fail(f"hybrid: the tuner's N=4 choice is {choice}, not the "
             f"{want} this phase runs")

    # Eq. 14 per device at each stage, for a replica's microbatch
    built = {z: _hybrid_plan(z) for z in (0, *HYBRID_ZERO)}
    plans = {z: cp for z, (cp, _) in built.items()}
    cfg = built[0][1]
    graph = uvit_pipeline_graph(cfg, batch=PLAN_BATCH // HYBRID_M
                                // HYBRID_DP, hw=H100_SXM)
    tabs = plans[0].step_tables()
    eq14 = {z: peak_memory(
        profile_partition(graph, plans[z].partition), HYBRID_PP, 1,
        wave=True, V=HYBRID_V,
        windows=(tabs.W_down + tabs.W_up, tabs.W_turn, tabs.W_skip),
        wire_bytes=WIRE_BYTES["bfloat16"], dp=HYBRID_DP, zero_stage=z)
        for z in plans}
    card = torch.cuda.get_device_properties(0).total_memory
    n_ranks = HYBRID_DP * HYBRID_PP
    log(f"[hybrid] Eq. 14 per device, UViT-H {cfg.n_layers} of 32 blocks "
        f"P={HYBRID_PP} dp={HYBRID_DP} V={HYBRID_V} M={HYBRID_M}, "
        f"{PLAN_BATCH // HYBRID_M // HYBRID_DP} samples a replica's "
        "microbatch: "
        + ", ".join(f"ZeRO-{z} {eq14[z] / 1e9:.3f} GB (x{n_ranks} = "
                    f"{n_ranks * eq14[z] / 1e9:.3f} GB)" for z in eq14)
        + f"; the card holds {card / 1e9:.3f} GB; ZeRO-0 is not run")
    one = _hybrid_reference()
    left = release(torch)
    if left >= 1e9:
        fail(f"hybrid: {left / 1e9:.2f} GB still allocated after the "
             "one-process reference")
    for z in plans:
        if list(plans[z].partition.cuts) != one["cuts"]:
            fail(f"hybrid: the ranks' cuts {plans[z].partition.cuts} at "
                 f"ZeRO-{z} are not the one-process reference's "
                 f"{one['cuts']}")
    log(f"[hybrid] one-process reference on the same plan (cuts "
        f"{one['cuts']}; the tuner's measured-cost cuts at N=4: "
        f"{choice['cuts']}): losses {one['losses']}; launches "
        f"{one['launches']}; peak {one['peak_bytes'] / 1e9:.3f} GB")

    env = dict(os.environ, REPRO_TORCH_NO_BUILD="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src")]
                   + [p for p in os.environ.get("PYTHONPATH", "").split(
                       os.pathsep) if p]))
    runs, walls = {}, {}
    for z in HYBRID_ZERO:
        runs[z], walls[z] = _hybrid_run(
            z, os.path.join(ROOT, "build", f"chip_smoke_hybrid{z}"), env,
            RANK_CKPT_SAVE + ["--ckpt-dir", ckdir] if z == 2 else [])
    out = dict(card=smi_line, argv=HYBRID_ARGV, wall_s=walls,
               eq14_per_device_bytes=eq14, card_bytes=card, zero={})
    launched = {}
    first = one["losses"][0]
    live = one["hop_bytes_per_step"]["live"]
    for z, docs in runs.items():
        what = f"hybrid ZeRO-{z}"
        for d in docs:
            if not d["device"].startswith("cuda") or d["ring"] != "gloo" \
                    or not d["staged"] or d["dp"] != HYBRID_DP:
                fail(f"{what}: rank {d['rank']} ran on {d['device']} over "
                     f"{d['ring']} (staged {d['staged']}, dp {d['dp']})")
            spec = d["spec"]
            if (spec["P"], spec["V"], spec["M"], spec["dp"],
                    spec["zero_stage"], spec["cuts"]) != (
                    HYBRID_PP, HYBRID_V, HYBRID_M, HYBRID_DP, z,
                    one["cuts"]):
                fail(f"{what}: rank {d['rank']} planned {spec}")
        # losses: the ranks agree; step 0 against the one-process run
        probe = [d["probe"]["loss"] for d in docs]
        losses = [[d["train"]["losses"][str(s)] for s in range(HYBRID_STEPS)]
                  for d in docs]
        if len(set(probe)) != 1 or any(x != losses[0] for x in losses):
            fail(f"{what}: the ranks disagree: probe {probe}, {losses}")
        for x in (probe[0], losses[0][0]):
            if not abs(x - first) <= HYBRID_LOSS_BAR * abs(first):
                fail(f"{what}: step 0 loss {x} vs the one-process run's "
                     f"{first} (bar {HYBRID_LOSS_BAR})")
        if any(d["train"]["skipped_steps"] for d in docs):
            fail(f"{what}: a rank skipped a step")
        # fingerprints of the whole gradient, each data replica's ranks
        worst, worst_at = 0.0, ""
        for di in range(HYBRID_DP):
            got = {}
            for d in docs:
                if d["data"] == di:
                    got.update(d["probe"]["fingerprints"])
            if sorted(got) != sorted(one["fingerprints"]):
                fail(f"{what}: fingerprint keys differ: "
                     f"{sorted(set(got) ^ set(one['fingerprints']))[:10]}")
            w, at = _fingerprint_errs(got, one["fingerprints"])
            if w > worst or not worst_at:
                worst, worst_at = w, f"{at} (data {di})"
        if worst > HYBRID_FINGERPRINT_BAR:
            fail(f"{what}: gradient {worst_at} ||err||/||g|| {worst:.3e} "
                 f"against the one-process step 0 (bar "
                 f"{HYBRID_FINGERPRINT_BAR})")
        # the data group's bytes and calls, probe and every step
        for d in docs:
            for key, step in [("probe", False)] + [
                    (str(s), True) for s in range(HYBRID_STEPS)]:
                nb, calls = hybrid_bytes(plans[z], d["pipe"], step)
                got = (d["probe"]["data_bytes"], d["probe"]["data_calls"]) \
                    if key == "probe" else (
                        d["step_data_bytes"][key]["bytes"],
                        d["step_data_bytes"][key]["calls"])
                if got != (nb, calls):
                    fail(f"{what}: rank {d['rank']} {key} data group "
                         f"{got}, arithmetic {(nb, calls)}")
        # ring bytes, each direction over the ranks: the one-process walk's
        ring = {f"{p} {k}": sum(d["probe"]["ring_bytes"][p][k] for d in docs)
                for p in ("fwd", "bwd") for k in ("sent", "received")}
        if set(ring.values()) != {live}:
            fail(f"{what}: ring bytes {ring}, want the one-process "
                 f"HOP_BYTES live {live} a step each")
        # launches: every replica runs every block call of a step
        probe_l = {k: sum(d["probe"]["launches"][k] for d in docs)
                   for k in docs[0]["probe"]["launches"]}
        for k in ("flash_attention", "skip_concat_matmul"):
            if probe_l[k] != HYBRID_DP * one["launches_per_step"][k]:
                fail(f"{what}: {k} launched {probe_l[k]} times in the "
                     f"ranks' forward+backward; want {HYBRID_DP} x the "
                     f"one-process step's {one['launches_per_step'][k]}")
        ranks_l = {k: sum(d["launches"][k] for d in docs)
                   for k in docs[0]["launches"]}
        for k, v in ranks_l.items():
            launched[k] = launched.get(k, 0) + v
        steps = {s: [d["train"]["step_seconds"][str(s)] for d in docs]
                 for s in range(HYBRID_STEPS)}
        coll = {k: [d["step_data_bytes"][str(s)]["seconds"][k]
                    for d in docs for s in range(1, HYBRID_STEPS)]
                for k in ("all_reduce", "all_gather", "reduce_scatter")}
        out["zero"][z] = dict(
            probe_loss=probe[0], losses=losses[0],
            one_process_losses=one["losses"][:HYBRID_STEPS],
            worst_rel_grad_err=worst, worst_grad=worst_at,
            ring_bytes=ring, hop_bytes_live=live,
            probe_data_bytes={d["rank"]: d["probe"]["data_bytes"]
                              for d in docs},
            step_data_bytes={d["rank"]: d["step_data_bytes"]["1"]
                             for d in docs},
            probe_launches=probe_l, launches=ranks_l,
            step_seconds=steps,
            step_seconds_max=[max(v) for v in steps.values()],
            collective_seconds_after_first=coll,
            probe_seconds=[d["probe"]["seconds"] for d in docs],
            peaks={d["rank"]: dict(init=d["probe"]["init_peak_bytes"],
                                   probe=d["probe"]["peak_bytes"],
                                   train=d["train"]["peak_bytes"])
                   for d in docs},
            data_group=docs[0]["data_group"])
    z1, z2 = (out["zero"][z] for z in HYBRID_ZERO)
    for s in range(HYBRID_STEPS):
        a, b = z1["losses"][s], z2["losses"][s]
        if not abs(a - b) <= HYBRID_ZERO_BAR * abs(a):
            fail(f"hybrid: step {s} loss ZeRO-1 {a} vs ZeRO-2 {b} (bar "
                 f"{HYBRID_ZERO_BAR})")
    for r in z1["peaks"]:
        if not z2["peaks"][r]["train"] < z1["peaks"][r]["train"]:
            fail(f"hybrid: rank {r} peaked at {z2['peaks'][r]['train']} B "
                 f"at ZeRO-2, not below ZeRO-1's {z1['peaks'][r]['train']}")
    rec["hybrid"] = out
    log(f"[hybrid] UViT-H ({HYBRID_LAYERS} of 32 blocks) on the tuner's "
        f"N=4 plan P={HYBRID_PP} "
        f"G={HYBRID_DP} V={HYBRID_V} M={HYBRID_M}, global batch "
        f"{PLAN_BATCH}, four ranks on one card (gloo ring and data group "
        f"staged through pinned host memory; {z1['data_group']}); {smi_line}")
    for z in HYBRID_ZERO:
        o = out["zero"][z]
        log(f"[hybrid] ZeRO-{z}: torchrun {walls[z]:.1f} s; step-0 loss "
            f"{o['probe_loss']!r} (one process {first!r}); AdamW losses "
            f"{o['losses']} (one process {o['one_process_losses']}); "
            f"gradient fingerprints worst ||err||/||g|| "
            f"{o['worst_rel_grad_err']:.3e} ({o['worst_grad']})")
        log(f"[hybrid] ZeRO-{z}: ring bytes {o['ring_bytes']} = HOP_BYTES "
            f"live {live}; data group a step (rank: bytes, calls, host s) "
            + "; ".join(f"{r}: {v['bytes']} {v['calls']} "
                        f"{ {k: round(x, 4) for k, x in v['seconds'].items()} }"
                        for r, v in o["step_data_bytes"].items())
            + " = the arithmetic")
        log(f"[hybrid] ZeRO-{z}: launches of the forward+backward over the "
            f"ranks {o['probe_launches']} = {HYBRID_DP} x the one-process "
            f"step's; step s (slowest rank) "
            f"{[round(x, 4) for x in o['step_seconds_max']]}")
        for r, pk in o["peaks"].items():
            log(f"[hybrid] ZeRO-{z} rank {r}: peak GB set-up "
                f"{pk['init'] / 1e9:.3f}, probe {pk['probe'] / 1e9:.3f}, "
                f"train {pk['train'] / 1e9:.3f}; Eq. 14 per device "
                f"{eq14[z] / 1e9:.3f}")
    log(f"[hybrid] not measurable on one card: the all-gather and "
        f"reduce-scatter over NVLink (NCCL, a card a rank); phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"hybrid": launched, "hybrid reference": one["launches"]}, runs[2]


# ---------------------------------------------------------------------------
# phase 14: checkpoints over ranks -- the hybrid ZeRO-2 world's save, and an
# elastic resume of it as the ranks phase's four pipeline ranks
# ---------------------------------------------------------------------------

# the hybrid phase's ZeRO-2 run: a save of step 3, step 3, a stop (no final
# save)
RANK_CKPT_SAVE = ["--steps", str(HYBRID_STEPS + 1), "--ckpt-every",
                  str(HYBRID_STEPS), "--faults", f"stop@{HYBRID_STEPS + 1}"]
RANK_CKPT_STEP = HYBRID_STEPS


def _set_arg(argv: list, flag: str, value: str) -> list:
    """``argv`` with ``flag``'s value replaced by ``value``."""
    out = list(argv)
    out[out.index(flag) + 1] = value
    return out


# the resume: the ranks phase's plan (P=4, one replica, ZeRO-0) at the
# hybrid phase's depth trains step 3 and stops (no second checkpoint: the
# disk writes a chip run may make are bounded)
RANK_CKPT_RESUME = _set_arg(RANKS_ARGV, "--steps", str(RANK_CKPT_STEP + 1)) \
    + ["--resume", "--faults", f"stop@{RANK_CKPT_STEP + 1}", "--layers",
       str(HYBRID_LAYERS)]
HASH_WORKERS = 6          # host processes hashing the saved blocks


def _npz_members(path: str) -> dict:
    """``name -> (shape, dtype, offset)`` of every ``.npy`` member of an
    uncompressed npz: the file offset of each array's first byte, read
    from the zip's local headers and the ``.npy`` headers."""
    import zipfile

    import numpy as np
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                fail(f"{path}: {info.filename} is compressed")
            f.seek(info.header_offset)
            local = f.read(30)
            f.seek(info.header_offset + 30 + int.from_bytes(local[26:28],
                                                            "little")
                   + int.from_bytes(local[28:30], "little"))
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            shape, _, dtype = read(f)
            out[info.filename[:-len(".npy")]] = (shape, dtype, f.tell())
    return out


def _sha256_ranges(path: str, ranges: list) -> list:
    """SHA-256 of each ``(offset, nbytes, cut)`` range of a file (a worker
    of the hash pool): of the range's bytes, or with ``cut = (shape,
    itemsize, dim, parts, part)`` of the C-ordered bytes of part ``part``
    of the range seen as an array of ``shape`` cut along ``dim`` into
    ``parts`` equal parts (a rank's ZeRO shard of a block)."""
    import hashlib

    import numpy as np
    out = []
    with open(path, "rb") as f:
        for off, n, cut in ranges:
            f.seek(off)
            h = hashlib.sha256()
            if cut is not None:
                shape, itemsize, dim, parts, part = cut
                b = f.read(n)
                if len(b) != n:
                    raise EOFError(f"{path}: short at {off}")
                a = np.frombuffer(b, dtype=f"u{itemsize}").reshape(shape)
                h.update(np.ascontiguousarray(
                    np.split(a, parts, axis=dim)[part]))
                out.append(h.hexdigest())
                continue
            left = n
            while left:
                b = f.read(min(left, 1 << 24))
                if not b:
                    raise EOFError(f"{path}: short at {off}")
                h.update(b)
                left -= len(b)
            out.append(h.hexdigest())
    return out


def _slot_ranges(spec: dict) -> list:
    """Per stage stack, ``ranges[d][v]``: the blocks (of that stack's own
    numbering: the decoder's from the turnaround cut) slot ``v`` of device
    ``d`` holds, from a manifest's or a rank report's state spec."""
    cuts = spec["cuts"]
    mid = cuts[(len(cuts) - 1) // 2]
    return [[[(cuts[s], cuts[s + 1]) for s in ss] for ss in spec["enc_slots"]],
            [[(cuts[s] - mid, cuts[s + 1] - mid) for s in ss]
             for ss in spec["dec_slots"]]]


def _digest_tasks(doc: dict, digests: dict, man: dict, members: dict,
                  tasks: dict, want: dict, what: str) -> int:
    """Add to ``tasks`` (path -> ``[(offset, nbytes, cut)]``) and ``want``
    (path -> ``[(what, rank, leaf, slot, row, digest)]``) every range of
    the saved members that rank report ``doc``'s ``digests``
    (``held_digests``) name: each edge leaf whole, and each real block of
    the rank's rows of a stage leaf, found in the saved layout
    (``man["plan"]``) through the rank's own (``doc["spec"]``), cut to the
    rank's ZeRO shard where it holds one.  Returns the bytes of the
    ranges the rank holds whole (its blocks and edge leaves)."""
    saved = _slot_ranges(man["plan"])
    spec, dev = doc["spec"], doc["pipe"]
    if spec["num_param_stacks"] != 2 or man["plan"]["num_param_stacks"] != 2:
        fail(f"rank checkpoint: {what}: the block check reads two stacks")
    new = _slot_ranges(spec)
    counts = (spec["enc_counts"][dev], spec["dec_counts"][dev])
    nb = 0
    for i in range(man["num_leaves"]):
        path, shape, dtype, off = members[i]
        size = int(math.prod(shape)) * dtype.itemsize
        got = digests.get(str(i))
        if got is None:
            fail(f"rank checkpoint: {what}: rank {doc['rank']} has no "
                 f"digest of leaf {i}")
        if isinstance(got, str):                        # an edge leaf
            want.setdefault(path, []).append(
                (what, doc["rank"], i, None, None, got))
            tasks.setdefault(path, []).append((off, size, None))
            nb += size
            continue
        block = size // int(math.prod(shape[:3]))
        cut = ((tuple(shape[3:]), dtype.itemsize, got["dim"], got["parts"],
                got["part"]) if "dim" in got else None)
        stack = got["stack"]
        if [len(x) for x in got["rows"]] != list(counts[stack]):
            fail(f"rank checkpoint: {what}: rank {doc['rank']} leaf {i}: "
                 f"{[len(x) for x in got['rows']]} rows a slot, its plan's "
                 f"counts {counts[stack]}")
        for v, rows in enumerate(got["rows"]):
            lo = new[stack][dev][v][0]
            for r, digest in enumerate(rows):
                b = lo + r
                (ds, vs), rs = next(
                    ((dd, vv), b - a) for dd, sl in enumerate(saved[stack])
                    for vv, (a, z) in enumerate(sl) if a <= b < z)
                row = (ds * shape[1] + vs) * shape[2] + rs
                tasks.setdefault(path, []).append(
                    (off + row * block, block, cut))
                want.setdefault(path, []).append(
                    (what, doc["rank"], i, v, r, digest))
                nb += block
    return nb


def _members(step_dir: str, man: dict) -> dict:
    """Leaf index -> ``(path, shape, dtype, offset)`` of its member."""
    out = {}
    for sh in man["shards"]:
        path = os.path.join(step_dir, sh)
        for name, meta in _npz_members(path).items():
            out[int(name[1:])] = (path,) + meta
    return out


def _saves(doc: dict) -> list:
    """A rank report's save records, without their digests."""
    return [{k: v for k, v in x.items() if k != "digests"}
            for x in doc["saves"]]


def rank_checkpoint_phase(torch, rec, smi_line: str, ckdir: str,
                          save_docs: list) -> dict:
    """The ``hybrid`` phase's ZeRO-2 world (UViT-H at full width,
    ``HYBRID_LAYERS`` of its 32 blocks, the tuner's N=4 plan P=2 G=2 V=2 M=2, bf16, four ranks on the card
    over the staged gloo groups) saved step ``RANK_CKPT_STEP`` into
    ``ckdir`` (``RANK_CKPT_SAVE``: every rank gathers its share of the
    leaves whole into host memory and writes ``shard_<rank>.npz``), then
    trained that step (loss L3) and stopped.  Here one torchrun of four
    ranks on the ``ranks`` phase's plan (P=4, one replica, ZeRO-0,
    ``RANK_CKPT_RESUME``) resumes it: the fingerprints differ, so each
    rank reads the saved blocks its new rows hold (the elastic path),
    and trains step 3.
    Held, bitwise, by SHA-256 (``--rank-report``'s ``held_digests``
    against the same ranges of the saved members, hashed here by
    ``HASH_WORKERS`` processes): each saving ZeRO-2 rank's pieces at the
    save (its shard of each block, cut from the saved block) and each
    resumed rank's rows after the restore are the saved members' bytes.
    Held besides: every save landed at the first attempt; every rank
    resumed step 3 elastically; each rank read no more than the blocks
    its rows hold plus the edge leaves, and the ranks hashed every shard
    once; the resumed step-3 loss within ``HYBRID_LOSS_BAR`` of L3;
    flash and skip launched in the resumed ranks.  Printed: the
    checkpoint's bytes, each writer's gather bytes and seconds, write,
    hash and GC seconds, each rank's blocking seconds at the save, each
    rank's restore seconds and bytes read.  The directory is removed at
    the end.  Returns the resumed ranks' launches (``rank checkpoint``)."""
    import concurrent.futures
    import multiprocessing
    import shutil

    def step_dir(step):
        return os.path.join(ckdir, f"step_{step:09d}")

    t_phase = time.perf_counter()
    step3 = RANK_CKPT_STEP
    try:
        # ---- the save, as the ZeRO-2 ranks report it
        if sorted(os.listdir(ckdir)) != [os.path.basename(step_dir(step3))]:
            fail(f"rank checkpoint: {sorted(os.listdir(ckdir))} under the "
                 f"checkpoint directory, want step {step3} alone")
        for d in save_docs:
            got = [(x["step"], x["attempts"], bool(x["path"]),
                    x.get("landed"), "digests" in x) for x in d["saves"]]
            if got != [(step3, 1, True, True, True)]:
                fail(f"rank checkpoint: rank {d['rank']} saves "
                     f"{_saves(d)}")
        l3 = save_docs[0]["train"]["losses"].get(str(step3))
        if l3 is None or any(d["train"]["losses"].get(str(step3))
                             != l3 for d in save_docs):
            fail("rank checkpoint: the saving ranks' step "
                 f"{step3} losses differ or are missing")
        with open(os.path.join(step_dir(step3), "manifest.json")) as f:
            man = json.load(f)
        nranks = HYBRID_DP * HYBRID_PP
        if man["num_hosts"] != nranks or len(man["shards"]) != nranks:
            fail(f"rank checkpoint: manifest of {man['num_hosts']} hosts, "
                 f"shards {man['shards']}")
        shard_bytes = {sh: os.path.getsize(os.path.join(step_dir(step3), sh))
                       for sh in man["shards"]}
        total = sum(shard_bytes.values())
        log(f"[rank-ckpt] {smi_line}: UViT-H at full width, "
            f"{HYBRID_LAYERS} of 32 blocks, the "
            f"ZeRO-2 world P={HYBRID_PP} G={HYBRID_DP} V={HYBRID_V} saved "
            f"step {step3}: {man['num_leaves']} leaves, {total} "
            f"bytes in {nranks} shards {list(shard_bytes.values())}")
        for d in save_docs:
            x = d["saves"][0]
            log(f"[rank-ckpt] save rank {d['rank']}: blocking "
                f"{x['blocking_s']:.2f} s (gather {x['gather_s']:.2f} s: "
                f"{x['gather_bytes_in']} bytes in, {x['gather_bytes_out']} "
                f"out); writes {x['leaves_written']} leaves, {x['bytes']} "
                f"bytes: npz {x['write_s']:.2f} s, SHA-256 "
                f"{x['hash_s']:.2f} s, GC {x['gc_s']:.3f} s")

        # ---- the elastic resume, four pipeline ranks
        out_dir = os.path.join(ROOT, "build", "chip_smoke_rank_ckpt")
        shutil.rmtree(out_dir, ignore_errors=True)
        env = dict(os.environ, REPRO_TORCH_NO_BUILD="1",
                   PYTHONPATH=os.pathsep.join(
                       [os.path.join(ROOT, "src")]
                       + [p for p in os.environ.get("PYTHONPATH", "").split(
                           os.pathsep) if p]))
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(RANKS_D), "-m",
               "repro_torch.launch.train", *RANK_CKPT_RESUME, "--ckpt-dir",
               ckdir, "--rank-report", out_dir]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                              text=True, timeout=RANKS_TIMEOUT)
        wall = time.perf_counter() - t0
        with open(os.path.join(OUT_DIR, "rank_checkpoint.log"), "w") as f:
            f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
        if proc.returncode != 0:
            fail(f"rank checkpoint: the resume exited {proc.returncode}:\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        docs = []
        for r in range(RANKS_D):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                docs.append(json.load(f))
        shutil.rmtree(out_dir, ignore_errors=True)
        for d in docs:
            got = d["resumed"]
            if not got or got["step"] != step3 or not got["elastic"] \
                    or got["saved_fingerprint"] == got["fingerprint"]:
                fail(f"rank checkpoint: rank {d['rank']} resumed {got}")
            loss = d["train"]["losses"].get(str(step3))
            if sorted(d["train"]["losses"]) != [str(step3)] or \
                    not abs(loss - l3) <= HYBRID_LOSS_BAR * abs(l3):
                fail(f"rank checkpoint: rank {d['rank']} losses "
                     f"{d['train']['losses']}, the saving world's step "
                     f"{step3} {l3} (bar {HYBRID_LOSS_BAR})")

        # ---- bitwise: what each rank held against the saved members
        members = _members(step_dir(step3), man)
        tasks, want, bound = {}, {}, {}
        for d in save_docs:
            _digest_tasks(d, d["saves"][0]["digests"], man, members, tasks,
                          want, f"saved step {step3}")
        for d in docs:
            bound[d["rank"]] = _digest_tasks(
                d, d["restore"]["digests"], man, members, tasks, want,
                f"restored step {step3}")
        t0 = time.perf_counter()
        # spawned, not forked: this process holds threads and a CUDA context
        with concurrent.futures.ProcessPoolExecutor(
                HASH_WORKERS, mp_context=multiprocessing.get_context(
                    "spawn")) as pool:
            futs = {p: pool.submit(_sha256_ranges, p, rs)
                    for p, rs in tasks.items()}
            hashed = {p: f.result() for p, f in futs.items()}
        hash_s = time.perf_counter() - t0
        checked = {}
        for p in tasks:
            for w, h in zip(want[p], hashed[p]):
                n, bad = checked.setdefault(w[0], [0, []])
                checked[w[0]][0] = n + 1
                if w[5] != h:
                    bad.append(w[1:5])
        for what, (n, bad) in checked.items():
            if bad:
                fail(f"rank checkpoint: {what}: {len(bad)} of {n} blocks "
                     f"and edge leaves differ from the saved bytes: "
                     f"{bad[:8]}")
        checked_bytes = sum(x[1] for rs in tasks.values() for x in rs)

        # ---- bytes read, hashing once, launches
        for d in docs:
            if d["restore"]["bytes_read"] > bound[d["rank"]]:
                fail(f"rank checkpoint: rank {d['rank']} read "
                     f"{d['restore']['bytes_read']} bytes, more than its "
                     f"blocks and edge leaves, {bound[d['rank']]}")
        hashed_by_ranks = sum(d["restore"]["hashed_bytes"] for d in docs)
        if hashed_by_ranks != total:
            fail(f"rank checkpoint: the ranks hashed {hashed_by_ranks} "
                 f"bytes, the shards hold {total}")
        launched = {k: sum(d["launches"][k] for d in docs)
                    for k in docs[0]["launches"]}
        for k in ("flash_attention", "skip_concat_matmul"):
            if not launched[k]:
                fail(f"rank checkpoint: {k} never launched in the resumed "
                     f"ranks ({launched})")
        peaks = {d["rank"]: d["train"]["peak_bytes"] for d in docs}
        out = dict(card=smi_line, bytes=total, shard_bytes=shard_bytes,
                   leaves=man["num_leaves"],
                   saves={d["rank"]: _saves(d)[0] for d in save_docs},
                   l3=l3, resume_wall_s=wall, resume_argv=RANK_CKPT_RESUME,
                   restores={d["rank"]: {k: v for k, v in
                                          d["restore"].items()
                                          if k != "digests"} for d in docs},
                   bytes_bound=bound, losses={d["rank"]: d["train"][
                       "losses"][str(step3)] for d in docs},
                   checked={k: n for k, (n, _) in checked.items()},
                   checked_bytes=checked_bytes, parent_hash_s=hash_s,
                   launches=launched, peaks=peaks)
        rec["rank checkpoint"] = out
        log(f"[rank-ckpt] resume as {RANKS_D} ranks P={RANKS_D} dp=1 "
            f"ZeRO-0: elastic (fingerprint "
            f"{docs[0]['resumed']['saved_fingerprint']} -> "
            f"{docs[0]['resumed']['fingerprint']}); torchrun "
            f"{wall:.1f} s; step {step3} loss "
            f"{docs[0]['train']['losses'][str(step3)]!r} "
            f"(the saving world's {l3!r})")
        for d in docs:
            x = d["restore"]
            log(f"[rank-ckpt] restore rank {d['rank']}: {x['total_s']:.2f} s "
                f"(verify {x['verify_s']:.2f} s hashing {x['hashed_bytes']} "
                f"bytes, read {x['read_s']:.2f} s); read {x['bytes_read']} "
                f"bytes (its blocks and edge leaves: {bound[d['rank']]}); "
                f"peak {d['train']['peak_bytes'] / 1e9:.3f} GB")
        log(f"[rank-ckpt] bitwise the saved members, blocks and edge "
            f"leaves: {out['checked']}, {checked_bytes} bytes (hashed "
            f"here in {hash_s:.1f} s by {HASH_WORKERS} processes); launches "
            f"{launched}; phase {time.perf_counter() - t_phase:.1f} s")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    return launched


# ---------------------------------------------------------------------------
# phase 11: the supervisor over ranks -- the JAX supervisor's drills at
# uvit-nano, then UViT-H at full width on the tuner's N=4 plan, every
# generation a world of rank processes grouped by host
# ---------------------------------------------------------------------------

DRILL_STEPS = 12
# the one-process reference of the drills' plan: one data replica of the
# P=2 pipeline (the ranks' gen 0 runs two, gen 1 one)
DRILL_PLAN = ["--arch", "uvit-nano", "--pipeline", "--devices", "2", "--pp",
              "2", "--microbatches", "4", "--global-batch", "8", "--steps",
              str(DRILL_STEPS), "--lr", "1e-3", "--wire-dtype", "float32",
              "--log-every", "4", "--device", "cuda"]
# the JAX drill's supervisor (tests/helpers/supervisor_drill.py): 2 hosts x
# 2 ranks, dp=2 pp=2; every rank on the one card over the staged gloo ring
DRILL_CFG = dict(num_hosts=2, devices_per_host=2, steps=DRILL_STEPS,
                 global_batch=8, arch="uvit-nano", dp=2, pp=2,
                 microbatches=4, wire_dtype="float32", lr=1e-3, ckpt_every=4,
                 stall_timeout=8.0, miss_budget=2, poll=0.2,
                 backoff_base=0.2, log_every=4, device="cuda")
# (faults, rollback step, detecting event)
DRILLS = (("hostdown@8:1", 8, "hostdown"), ("hang@6", 4, "hang"))
SHRUNK = (1, 2, 0)
# UViT-H at full width and the hybrid phase's depth on its ZeRO-2 plan at V=1
# (P=2 G=2, M=2, global batch 16, bf16) as 2 hosts x 2 ranks: host 1 dies
# after step 0; no checkpoint is written (steps 3, a save past the run,
# and the relaunch stops after step 2 without its final save)
UVIT_H_CFG = dict(num_hosts=2, devices_per_host=2, steps=HYBRID_STEPS,
                  global_batch=PLAN_BATCH, arch="uvit-h",
                  layers=HYBRID_LAYERS, dp=HYBRID_DP,
                  pp=HYBRID_PP, zero_stage=2, microbatches=HYBRID_M,
                  wire_dtype="bfloat16", ckpt_every=1000,
                  faults="hostdown@1:1",
                  relaunch_faults=f"stop@{HYBRID_STEPS}", stall_timeout=60.0,
                  startup_timeout=300.0, miss_budget=2, poll=0.2,
                  backoff_base=0.2, log_every=1, device="cuda")


# the trainer's one-process worker mode, the JAX trainer's hosts: host
# processes started by hand, each a whole replica of the plan on the card,
# meeting at the start.g<gen> FileBarrier and at each checkpoint step's
# commit barrier.  Gen 0: 2 hosts of the P=4 pipeline, host 1 exits after
# committing step 8, host 0 stops after step 10, before step 12's save
# (whose commit would wait for host 1 until the barrier's timeout); gen 1:
# one host of P=2 resumes step 8 (an elastic restore), steps 8-11
WORKERS_ARGV = ["--arch", "uvit-nano", "--pipeline", "--microbatches", "4",
                "--global-batch", "8", "--steps", str(DRILL_STEPS), "--lr",
                "1e-3", "--wire-dtype", "float32", "--log-every", "4",
                "--device", "cuda", "--ckpt-every", "4", "--resume"]
# (hosts, pipeline devices, faults) of each generation
WORKERS_GENS = ((2, 4, f"hostdown@8:1,stop@{DRILL_STEPS - 1}"),
                (1, 2, None))
WORKERS_ROLLBACK = 8
WORKERS_TIMEOUT = 300        # seconds for a generation's processes


def _free_bytes(torch) -> int:
    return torch.cuda.mem_get_info()[0]


def _wait_memory_back(torch, free0: int, what: str) -> int:
    """Wait (at most 60 s) until the card's free memory is back within 1 GB
    of ``free0``: a torn-down rank's memory returns when its process
    ends."""
    deadline = time.time() + 60.0
    while True:
        free = _free_bytes(torch)
        if free >= free0 - 1e9:
            return free
        if time.time() > deadline:
            fail(f"{what}: {(free0 - free) / 1e9:.2f} GB of the card's "
                 "memory not returned after teardown")
        time.sleep(0.5)


def _rank_results(logs_dir: str) -> dict:
    """``(gen, rank) -> the rank's result file`` (the per-step dump of a
    rank that was killed or exited, the full record of one that
    finished)."""
    out = {}
    for n in sorted(os.listdir(logs_dir)):
        m = re.fullmatch(r"result_h\d+\.r(\d+)\.g(\d+)\.json", n)
        if m:
            try:
                with open(os.path.join(logs_dir, n)) as f:
                    out[int(m.group(2)), int(m.group(1))] = json.load(f)
            except (OSError, ValueError):
                pass
    return out


def _check_rank_logs(logs_dir: str, what: str) -> list:
    """Every rank's log names the CUDA device it ran on."""
    names = []
    for n in sorted(os.listdir(logs_dir)):
        if not n.endswith(".log"):
            continue
        with open(os.path.join(logs_dir, n)) as f:
            text = f.read()
        line = next((x for x in text.splitlines()
                     if x.startswith("[train] device: cuda:")), None)
        if line is None:
            fail(f"{what}: rank log {n} names no CUDA device:\n"
                 f"{text[-3000:]}")
        names.append(f"{n}: {line[len('[train] device: '):]}")
    return names


def _gen_timing(events: list, results: dict) -> dict:
    """Seconds from each generation's launch to its gen-live event, and to
    the last of its ranks' first train beats (read from their result
    files: a generation that dies after one step may end before a poll
    saw it live); from the detection (hostdown/hang) to the next
    generation's gen-live."""
    launch = {e["gen"]: e["t"] for e in events if e["kind"] == "launch"}
    live = {e["gen"]: e["t"] for e in events if e["kind"] == "gen-live"}
    first = {}
    for (g, _), doc in results.items():
        beats = doc.get("beat_t") or {}
        if beats:
            t = beats[str(min(map(int, beats)))]
            first[g] = max(first.get(g, t), t)
    detect = [e for e in events if e["kind"] in ("hostdown", "hang")]
    out = {"launch_to_live_s": {g: live[g] - launch[g] for g in live},
           "launch_to_first_beats_s": {g: t - launch[g]
                                       for g, t in first.items()}}
    if detect and 1 in live:
        out["detect_to_next_live_s"] = live[1] - detect[0]["t"]
    return out


def _supervised(torch, sup, cfg, free0: int, what: str):
    """``Supervisor(cfg).run()``, with the card's free memory held back
    within 1 GB of ``free0`` after each generation's teardown.  Returns the
    result, the events and each teardown's record."""

    class Watched(sup.Supervisor):
        def _teardown(self, ranks):
            super()._teardown(ranks)
            t0 = time.perf_counter()
            free = _wait_memory_back(torch, free0, what)
            self.teardowns.append(dict(
                ranks=len(ranks), free_gb=free / 1e9,
                wait_s=time.perf_counter() - t0))

    s = Watched(cfg)
    s.teardowns = []
    res = s.run()
    return res, sup.read_events(res.events_path), s.teardowns


def _sum_launches(launched: dict, results: dict) -> dict:
    per = dict.fromkeys(launched, 0)
    for doc in results.values():
        for k, v in doc.get("launches", {}).items():
            per[k] += v
            launched[k] += v
    return per


def _host_workers(base: str, gen: int, hosts: int, devices: int,
                  faults, env: dict) -> list:
    """Generation ``gen`` of the one-process worker mode: host ``h`` of
    ``hosts`` as ``python -m repro_torch.launch.train --host-id h
    --num-hosts hosts``, each in a session of its own, all waited for (at
    most ``WORKERS_TIMEOUT`` s, then killed with whatever they started).
    Returns ``[(exit code, log text, result or None)]`` by host."""
    import signal
    procs = []
    for h in range(hosts):
        log_path = os.path.join(base, f"worker_h{h}.g{gen}.log")
        out = os.path.join(base, f"result_h{h}.g{gen}.json")
        cmd = [sys.executable, "-m", "repro_torch.launch.train",
               *WORKERS_ARGV, "--devices", str(devices), "--pp", str(devices),
               "--host-id", str(h), "--num-hosts", str(hosts),
               "--ckpt-dir", os.path.join(base, "ckpt"),
               "--heartbeat-dir", os.path.join(base, "hb"), "--gen",
               str(gen), "--out-json", out] + (
                   ["--faults", faults] if faults else [])
        with open(log_path, "w") as lf:
            procs.append((subprocess.Popen(
                cmd, env=env, cwd=ROOT, stdout=lf, stderr=subprocess.STDOUT,
                start_new_session=True), log_path, out))
    deadline = time.time() + WORKERS_TIMEOUT
    try:
        for p, _, _ in procs:
            p.wait(timeout=max(deadline - time.time(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, _, _ in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
    done = []
    for p, log_path, out in procs:
        with open(log_path) as f:
            text = f.read()
        try:
            with open(out) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            doc = None
        done.append((p.returncode, text, doc))
    return done


def worker_mode_drill(torch, base: str, ref_losses: dict,
                      env: dict) -> tuple:
    """The one-process worker mode on the card (``WORKERS_GENS``): gen 0's
    host 1 exits 42 after committing step 8 and host 0 exits 0 after step
    10, both through the start barrier and the commit barriers of steps 4
    and 8 with no warning; step 8 is the newest complete step, its
    manifest names both hosts' shards; gen 1 resumes it elastically on P=2
    and trains steps 8-11; every host's losses at rtol 1e-4 to the
    one-process P=2 run.  Returns the record and the workers' launches."""
    from repro_torch.checkpoint import complete_steps, verify_step
    from repro_torch.runtime.resilience import EXIT_KILLED
    what = "worker mode"
    ckpt = os.path.join(base, "ckpt")
    launched = dict.fromkeys(_launches(), 0)
    out, errs = {"gens": []}, []
    free0 = _free_bytes(torch)
    t_all = time.perf_counter()
    for gen, (hosts, devices, faults) in enumerate(WORKERS_GENS):
        t0 = time.perf_counter()
        got = _host_workers(base, gen, hosts, devices, faults, env)
        wall = time.perf_counter() - t0
        want = [0, EXIT_KILLED] if gen == 0 else [0]
        if [c for c, _, _ in got] != want:
            fail(f"{what} gen {gen}: exit codes {[c for c, _, _ in got]}, "
                 f"want {want}:\n" + "\n".join(t[-3000:] for _, t, _ in got))
        span = (range(DRILL_STEPS - 1), range(WORKERS_ROLLBACK)) \
            if gen == 0 \
            else (range(WORKERS_ROLLBACK, DRILL_STEPS),)
        for h, ((_, text, doc), steps) in enumerate(zip(got, span)):
            if "[train] device: cuda:" not in text or "did not close" in text \
                    or doc is None:
                fail(f"{what} gen {gen} host {h}: no CUDA device line, a "
                     f"barrier that did not close, or no result:\n"
                     f"{text[-3000:]}")
            losses = {int(k): v for k, v in doc["losses"].items()}
            if sorted(losses) != list(steps):
                fail(f"{what} gen {gen} host {h}: steps {sorted(losses)}, "
                     f"want {list(steps)}")
            for k, b in losses.items():
                a = ref_losses[k]
                if not (math.isfinite(b) and abs(a - b) <= 1e-4 * abs(a)):
                    fail(f"{what} gen {gen} host {h} step {k} loss {b} vs "
                         f"the one-process run's {a} (rtol 1e-4)")
                errs.append(abs(a - b) / abs(a))
            for k, v in doc.get("launches", {}).items():
                launched[k] += v
        if gen == 0:
            man = verify_step(ckpt, WORKERS_ROLLBACK)
            if complete_steps(ckpt)[-1] != WORKERS_ROLLBACK or \
                    man["num_hosts"] != 2 or man["shards"] != [
                        "shard_00000.npz", "shard_00001.npz"]:
                fail(f"{what}: complete steps {complete_steps(ckpt)}, "
                     f"step {WORKERS_ROLLBACK}'s manifest {man}")
        elif f"resumed from step {WORKERS_ROLLBACK} (elastic restore" \
                not in got[0][1]:
            fail(f"{what} gen 1 did not resume step {WORKERS_ROLLBACK} "
                 f"elastically:\n{got[0][1][-3000:]}")
        free = _wait_memory_back(torch, free0, f"{what} gen {gen}")
        out["gens"].append(dict(hosts=hosts, devices=devices, faults=faults,
                                codes=[c for c, _, _ in got], wall_s=wall,
                                free_gb_after=free / 1e9))
    for k in ("skip_concat_matmul", "flash_attention"):
        if not launched[k]:
            fail(f"{what}: {k} never launched in the workers: {launched}")
    out.update(wall_s=time.perf_counter() - t_all, max_rel_err=max(errs),
               free_gb_before=free0 / 1e9, launches=launched)
    log(f"[supervisor] worker mode (one process a host, uvit-nano): gen 0 "
        f"2 hosts x P=4, host 1 down after committing step "
        f"{WORKERS_ROLLBACK} (exit codes {out['gens'][0]['codes']}), gen 1 "
        f"one host of P=2 resumed step {WORKERS_ROLLBACK} elastically; "
        f"max rel err {max(errs):.2e} over {len(errs)} host losses; "
        f"gens {[round(g['wall_s'], 1) for g in out['gens']]} s; free GB "
        f"{free0 / 1e9:.2f} before, after each gen "
        f"{[round(g['free_gb_after'], 2) for g in out['gens']]}; launches "
        f"{launched}")
    return out, launched


def supervisor_phase(torch, rec, smi_line: str) -> tuple:
    """(a) the JAX supervisor's two drills at its own plan, every
    generation a world of uvit-nano ranks on the card, each merged
    trajectory at rtol 1e-4 to the one-process run of the plan, then the
    trainer's one-process worker mode (``worker_mode_drill``); (b) UViT-H
    at full width and the hybrid phase's depth (``HYBRID_LAYERS``) on the
    tuner's N=4 plan as 2 hosts x 2 ranks, host 1
    down after step 0, the survivor's two ranks trained from step 0 and
    held to the hybrid phase's ZeRO-2 losses.  The ranks load the kernels
    phase 2 built (``REPRO_TORCH_BUILD_DIR`` inherited,
    ``REPRO_TORCH_NO_BUILD=1``: a rank may not run nvcc, and the build
    directory must hold the same files after the phase).  Returns the
    ranks' launches and the one-process workers', read from their result
    files."""
    import shutil

    from repro_torch.kernels import build
    from repro_torch.launch import supervisor as sup
    from repro_torch.launch import train as train_mod

    out = {"card": smi_line}
    log(f"[supervisor] {smi_line}: every generation a world of rank "
        "processes grouped by host, all on the card over the staged gloo "
        "ring")
    libs = sorted(os.listdir(build.build_dir()))
    base = os.path.join(ROOT, "build", "chip_smoke_supervisor")
    shutil.rmtree(base, ignore_errors=True)
    worker_env = {"REPRO_TORCH_NO_BUILD": "1"}
    launched = dict.fromkeys(_launches(), 0)

    # (a) reference, then the drills
    t0 = time.perf_counter()
    ref = train_mod.run(train_mod._parse_args(DRILL_PLAN))
    ref_losses = dict(ref.losses)
    del ref
    release(torch)
    out["reference_s"] = time.perf_counter() - t0
    drills = {}
    for faults, rollback, detect in DRILLS:
        free0 = _free_bytes(torch)
        t0 = time.perf_counter()
        run_dir = os.path.join(base, detect)
        cfg = sup.SupervisorConfig(run_dir=run_dir, faults=faults,
                                   worker_env=worker_env, **DRILL_CFG)
        what = f"supervisor drill {faults}"
        res, events, downs = _supervised(torch, sup, cfg, free0, what)
        wall = time.perf_counter() - t0
        kinds = [e["kind"] for e in events]
        if not (res.ok and res.outcome == "done"
                and (res.generations, res.restarts) == (2, 1)
                and (res.final_hosts, tuple(res.final_plan)) == (1, SHRUNK)):
            fail(f"{what}: {res} events {kinds}")
        for k in (detect, "rollback", "shrink", "restart", "gen-live",
                  "done"):
            if k not in kinds:
                fail(f"{what}: no {k!r} event in {kinds}")
        worlds = [(e["hosts"], e["ranks"]) for e in events
                  if e["kind"] == "launch"]
        if worlds != [(2, 4), (1, 2)]:
            fail(f"{what}: generations of (hosts, ranks) {worlds}")
        rb = next(e for e in events if e["kind"] == "rollback")
        if rb["step"] != rollback:
            fail(f"{what}: rolled back to {rb['step']}, want {rollback}")
        hits = [e for e in events if e["kind"] == detect]
        budget = cfg.stall_timeout * cfg.miss_budget + 5 * cfg.poll
        if [e["host"] for e in hits] != [1 if detect == "hostdown" else 0] \
                or (detect == "hang" and hits[0]["age"] > budget):
            fail(f"{what}: {hits} (hang budget {budget} s)")
        if sorted(res.losses) != list(range(DRILL_STEPS)):
            fail(f"{what}: merged trajectory {sorted(res.losses)}")
        logs_dir = os.path.join(run_dir, "logs")
        results = _rank_results(logs_dir)
        # both generations, each rank's own record, against the reference
        errs = []
        for (g, r), doc in results.items():
            for k, b in doc.get("losses", {}).items():
                a = ref_losses[int(k)]
                if not (math.isfinite(b) and abs(a - b) <= 1e-4 * abs(a)):
                    fail(f"{what}: gen {g} rank {r} step {k} loss {b} vs "
                         f"the one-process run's {a} (rtol 1e-4)")
                errs.append(abs(a - b) / abs(a))
        if {g for g, _ in results} != {0, 1}:
            fail(f"{what}: rank results of generations "
                 f"{sorted({g for g, _ in results})}")
        devices = _check_rank_logs(logs_dir, what)
        per = _sum_launches(launched, results)
        timing = _gen_timing(events, results)
        drills[faults] = dict(
            wall_s=wall, kinds=kinds, rollback=rb["step"], worlds=worlds,
            detect={k: hits[0][k] for k in ("host", "age", "step")
                    if k in hits[0]},
            final_plan=list(res.final_plan), devices=devices,
            launches=per, max_rel_err=max(errs),
            free_gb_before=free0 / 1e9, teardowns=downs, **timing)
        log(f"[supervisor] drill {faults}: {' -> '.join(kinds)}; "
            f"worlds (hosts, ranks) {worlds}; rollback({rb['step']}) "
            f"shrink{SHRUNK}; detection {drills[faults]['detect']}; "
            f"launch->gen-live s {_rounded(timing['launch_to_live_s'])}; "
            f"detect->next gen-live "
            f"{timing.get('detect_to_next_live_s', float('nan')):.3f} s; "
            f"max rel err {max(errs):.2e} over {len(errs)} rank losses; "
            f"free GB {free0 / 1e9:.2f} before, after each teardown "
            f"{[round(d['free_gb'], 2) for d in downs]}; {wall:.1f} s")
        for d in devices:
            log(f"[supervisor]   {d}")
    out["drills"] = drills
    release(torch)
    workers_dir = os.path.join(base, "workers")
    os.makedirs(workers_dir)
    out["workers"], workers_launched = worker_mode_drill(
        torch, workers_dir, ref_losses, dict(
            os.environ, REPRO_TORCH_NO_BUILD="1", PYTHONPATH=os.pathsep.join(
                [os.path.join(ROOT, "src")]
                + [p for p in os.environ.get("PYTHONPATH", "").split(
                    os.pathsep) if p])))

    # (b) full width: UViT-H (the hybrid phase's depth) on the tuner's N=4
    # plan, host 1 down after step 0, no checkpoint
    release(torch)
    free0 = _free_bytes(torch)
    t0 = time.perf_counter()
    run_dir = os.path.join(base, "uvit-h")
    cfg = sup.SupervisorConfig(run_dir=run_dir, worker_env=worker_env,
                               **UVIT_H_CFG)
    what = "supervisor uvit-h"
    res, events, downs = _supervised(torch, sup, cfg, free0, what)
    wall = time.perf_counter() - t0
    kinds = [e["kind"] for e in events]
    if not (res.ok and (res.generations, res.restarts) == (2, 1)
            and (res.final_hosts, tuple(res.final_plan)) == (1, SHRUNK)):
        fail(f"{what}: {res} events {kinds}")
    worlds = [(e["hosts"], e["ranks"], e["plan"]) for e in events
              if e["kind"] == "launch"]
    want_worlds = [(2, 4, {"dp": 2, "pp": 2, "zero_stage": 2}),
                   (1, 2, {"dp": 1, "pp": 2, "zero_stage": 0})]
    if worlds != want_worlds:
        fail(f"{what}: generations {worlds}, want {want_worlds}")
    down = [e for e in events if e["kind"] == "hostdown"]
    rb = next((e for e in events if e["kind"] == "rollback"), None)
    if [e["host"] for e in down] != [1] or rb is None \
            or rb["step"] is not None or any(
                k in kinds for k in ("hang", "escalate", "peer-lost",
                                     "heartbeat-miss", "abort")):
        fail(f"{what}: events {events}")
    if 1 not in {e["gen"] for e in events if e["kind"] == "gen-live"}:
        fail(f"{what}: generation 1 never went live: {kinds}")
    ckpt = os.path.join(run_dir, "ckpt")
    steps_left = [n for n in (os.listdir(ckpt) if os.path.isdir(ckpt)
                              else ()) if n.startswith("step_")]
    if steps_left:
        fail(f"{what}: a checkpoint was written: {steps_left}")
    logs_dir = os.path.join(run_dir, "logs")
    results = _rank_results(logs_dir)
    hybrid = rec["hybrid"]["zero"][2]["losses"]
    gen1 = {r: doc for (g, r), doc in results.items() if g == 1}
    if sorted(gen1) != [0, 1]:
        fail(f"{what}: generation 1's rank results {sorted(gen1)}")
    held = {}
    for (g, r), doc in sorted(results.items()):
        got = {int(k): v for k, v in doc.get("losses", {}).items()}
        if g == 1 and (sorted(got) != list(range(HYBRID_STEPS))
                       or doc.get("start") != 0):
            fail(f"{what}: gen 1 rank {r} trained steps {sorted(got)} "
                 f"from {doc.get('start')}")
        for s, b in got.items():
            a = hybrid[s]
            if not (math.isfinite(b)
                    and abs(a - b) <= HYBRID_LOSS_BAR * abs(a)):
                fail(f"{what}: gen {g} rank {r} step {s} loss {b} vs the "
                     f"hybrid phase's ZeRO-2 {a} (rtol {HYBRID_LOSS_BAR})")
        held[f"g{g} r{r}"] = [got[s] for s in sorted(got)]
    devices = _check_rank_logs(logs_dir, what)
    per = _sum_launches(launched, results)
    for k in ("skip_concat_matmul", "flash_attention"):
        if not per[k]:
            fail(f"{what}: {k} never launched in the ranks: {per}")
    timing = _gen_timing(events, results)
    peaks = {f"g{g} r{r}": doc.get("peak_bytes")
             for (g, r), doc in sorted(results.items())}
    steps = {f"g{g} r{r}": doc.get("step_seconds")
             for (g, r), doc in sorted(results.items())}
    out["uvit_h"] = dict(
        wall_s=wall, kinds=kinds, worlds=worlds, losses=held,
        hybrid_zero2_losses=hybrid, step_seconds=steps, peak_bytes=peaks,
        devices=devices, launches=per, free_gb_before=free0 / 1e9,
        teardowns=downs, **timing)
    log(f"[supervisor] uvit-h ({HYBRID_LAYERS} of 32 blocks, P=2 G=2 "
        f"ZeRO-2 V=1, 2 hosts x 2 ranks, "
        f"hostdown@1:1): {' -> '.join(kinds)}; launch->gen-live s "
        f"{_rounded(timing['launch_to_live_s'])}, launch->last first train "
        f"beat s {_rounded(timing['launch_to_first_beats_s'])}; "
        f"detect->next gen-live "
        f"{timing.get('detect_to_next_live_s', float('nan')):.3f} s; "
        f"{wall:.1f} s")
    log(f"[supervisor]   losses {held} vs the hybrid phase's ZeRO-2 "
        f"{hybrid[:HYBRID_STEPS]} (rtol {HYBRID_LOSS_BAR})")
    log(f"[supervisor]   step s "
        f"{ {k: _rounded(v) for k, v in steps.items()} }")
    log(f"[supervisor]   peaks GB "
        f"{ {k: round(v / 1e9, 3) if v else v for k, v in peaks.items()} }"
        f"; free GB {free0 / 1e9:.2f} before, after each teardown "
        f"{[round(d['free_gb'], 2) for d in downs]}; launches {per}")
    for d in devices:
        log(f"[supervisor]   {d}")
    log(f"[supervisor] rank launches, read from the ranks' result files "
        f"(other processes; a killed rank's count stops at its last "
        f"step's dump): {launched}")
    out["rank_launches"] = launched
    if sorted(os.listdir(build.build_dir())) != libs:
        fail(f"supervisor: the build directory changed under the ranks: "
             f"{libs} -> {sorted(os.listdir(build.build_dir()))}")
    rec["supervisor"] = out
    shutil.rmtree(base, ignore_errors=True)
    return launched, workers_launched


def _rounded(d: dict) -> dict:
    return {k: round(v, 3) for k, v in sorted(d.items(), key=lambda x:
                                              int(x[0]))}


def release(torch) -> int:
    """Drop what the last phase left and return the bytes still allocated
    on the card (the trainer resets the peak statistics itself, so each
    train phase reports its own peak)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def _args() -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="the port's smoke test on one H100 (no arguments: "
                    "every phase)")
    ap.add_argument("--lm-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--sharded-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    return ap.parse_args()


def main() -> None:
    args = _args()
    if args.lm_rank is not None:
        lm_rank_worker(args.lm_rank, args.port, args.out)
        return
    if args.sharded_rank is not None:
        sharded_rank_worker(args.sharded_rank, args.port, args.out)
        return
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device visible (torch.cuda.is_available() is False); "
             "this smoke test runs only on a GPU")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"{src}/repro_torch not found: run from a checkout of the repo")
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT_DIR, exist_ok=True)
    rec: dict = {}
    t_start = time.perf_counter()

    # 1. card
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    rec["card"] = dict(name=name, nvidia_smi=smi_line,
                       count=torch.cuda.device_count(),
                       torch=torch.__version__, cuda=torch.version.cuda)
    log(f"[card] {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[card] nvidia-smi: {smi_line}")

    # 2. build, from the checkout's sources into a fresh directory
    from repro_torch.kernels import build
    os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(ROOT, "build",
                                                       "chip_smoke")
    for f in os.listdir(build.build_dir()) if os.path.isdir(
            build.build_dir()) else ():
        os.remove(os.path.join(build.build_dir(), f))
    t0 = time.perf_counter()
    built = build.build(verbose=True)
    if sorted(built) != sorted(build.SOURCES):
        fail(f"build: built {sorted(built)}, want {sorted(build.SOURCES)}")
    rec["build"] = dict(wall_s=time.perf_counter() - t0,
                        seconds={k: v["seconds"] for k, v in built.items()})
    log(f"[build] {sorted(built)} in {rec['build']['wall_s']:.1f} s "
        f"(nvcc each: {rec['build']['seconds']})")
    for k, v in built.items():
        for line in v["log"].splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                log(f"[build] {k}: {line.strip()}")

    # the bf16 kernels' tiling and the grids of the train steps' shapes
    from repro_torch.kernels.flash_attention.ops import bf16_config as fcfg
    from repro_torch.kernels.skip_matmul.ops import bf16_config as scfg
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    from repro_torch.kernels.linear_scan import scan_config
    tiling = {"skip_concat_matmul bf16": scfg(),
              **{f"flash_attention bf16 D={d}": fcfg(d)
                 for d in (64, 80, 112, 128, 224)}}
    for d in ("bfloat16", "float32"):
        for bwd in (False, True):
            tiling[f"gated_linear_scan {d} {('forward', 'backward')[bwd]}"] = (
                scan_config(getattr(torch, d), getattr(torch, d), bwd))
    sk = tiling["skip_concat_matmul bf16"]
    grids = {f"skip M={M} N={N}": -(-M // sk["tile_m"]) * -(-N // sk["tile_n"])
             for M, N in ((516, 2560), (2048, 2048))}
    # UViT-H, Hunyuan-DiT (D=128) and the UNet's levels (B*H = 16*8, S =
    # 256 at D=112, 64 and 16 at D=224)
    grids.update({
        f"flash D={d} B*H={bh} S={S}":
            bh * -(-S // tiling[f"flash_attention bf16 D={d}"]["query_rows"])
        for d, bh, S in ((128, 40, 258), (128, 32, 1024), (112, 128, 256),
                         (224, 128, 64), (224, 128, 16),
                         (64, 30, 4096), (128, 64, 4096), (80, 64, 4096),
                         (64, 240, 1), (80, 64, 1))})
    grids.update({f"{k} R={R} T={T} C={C}":
                  R * -(-C // v["channels"]) * -(-T // v["chunk"])
                  for k, v in tiling.items() if k.startswith("gated")
                  for R, T, C in SCAN_SHAPES.values()})
    rec["tiling"] = dict(kernels=tiling, grids=grids, sms=sms)
    for k, v in tiling.items():
        log(f"[tiling] {k}: {v}; {v['blocks_per_sm'] * sms} blocks resident "
            f"on {sms} SMs")
    log(f"[tiling] grids (blocks): {grids}")

    # 3. kernels (each phase's seconds in rec["phase_s"])
    phase_s = rec.setdefault("phase_s", {})
    t0 = time.perf_counter()
    main_rows = {"skip_concat_matmul": check_skip_matmul(torch, rec),
                 "flash_attention": check_flash(torch, rec)}
    check_flash_long(torch, rec)
    phase_s["kernels skip, flash"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    main_rows["gated_linear_scan"] = check_scan(torch, rec)
    torch.cuda.empty_cache()
    phase_s["kernels scan"] = time.perf_counter() - t0

    # 3b. kernel_check: the launch predicates against real launches
    t0 = time.perf_counter()
    kernel_check_phase(torch, rec)
    phase_s["kernel_check"] = time.perf_counter() - t0

    # 4. pipeline parity, then the UNet's card-vs-CPU parity
    t0 = time.perf_counter()
    for kind, D, M, over in PARITY_CASES:
        pipeline_parity(torch, rec, kind, D, M, **over)
    pipeline_parity_bf16(torch, rec)
    linear_parity(torch, rec)
    unet_parity(torch, rec)
    torch.cuda.empty_cache()
    phase_s["parity"] = time.perf_counter() - t0

    # 5. plan: measured block costs, the tuner, UViT-H on the tuner's plan
    counts = {}
    left = release(torch)
    if left >= 1e9:
        fail(f"plan: {left / 1e9:.2f} GB still allocated before the phase")
    t0 = time.perf_counter()
    counts["plan"] = plan_phase(torch, rec)
    phase_s["plan"] = time.perf_counter() - t0

    # 6-8. train, one model at a time; after UViT-H, its checkpoint phase
    for arch in TRAIN_ARCHS:
        left = release(torch)
        log(f"[train] {left / 1e9:.3f} GB allocated before {arch}")
        if left >= 1e9:
            fail(f"train {arch}: {left / 1e9:.2f} GB still allocated; the "
                 "previous phase was not released")
        t0 = time.perf_counter()
        counts[arch] = train(torch, rec, arch)
        phase_s[f"train {arch}"] = time.perf_counter() - t0
        if arch == "uvit-h":
            # 6b. PULSE against the skip-carry baseline at UViT-H's width
            left = release(torch)
            if left >= 1e9:
                fail(f"baseline: {left / 1e9:.2f} GB still allocated; the "
                     "previous phase was not released")
            t0 = time.perf_counter()
            counts["baseline"] = baseline_phase(torch, rec)
            phase_s["baseline"] = time.perf_counter() - t0
            release(torch)
            t0 = time.perf_counter()
            counts.update(checkpoint_phase(torch, rec, smi_line))
            phase_s["checkpoint"] = time.perf_counter() - t0

    # 9. train the SDv2 UNet at full width, without the pipeline
    left = release(torch)
    if left >= 1e9:
        fail(f"train sdv2-unet-full: {left / 1e9:.2f} GB still allocated; "
             "the previous phase was not released")
    t0 = time.perf_counter()
    counts["sdv2-unet-full"] = train(torch, rec, "sdv2-unet-full")
    phase_s["train sdv2-unet-full"] = time.perf_counter() - t0
    release(torch)

    # 10. SkipViT on the wave pipeline, card vs CPU
    t0 = time.perf_counter()
    counts["skipvit train"] = skipvit_train(torch, rec)
    counts["skipvit wave-asym"] = skipvit_wave_asym(torch, rec)
    phase_s["skipvit"] = time.perf_counter() - t0
    log(f"[skipvit] phase {rec['phase_s']['skipvit']:.1f} s")

    # 16. lm: smollm-360m on both D=4 plans, qwen3-moe at full width, the
    # seven LM smoke keys through the trainer
    left = release(torch)
    if left >= 1e9:
        fail(f"lm: {left / 1e9:.2f} GB still allocated; the previous phase "
             "was not released")
    t0 = time.perf_counter()
    for plan, c in lm_smollm(torch, rec).items():
        counts[f"lm smollm-360m {plan}"] = c
    release(torch)
    counts["lm qwen3-moe-30b-a3b"] = lm_qwen3(torch, rec)
    release(torch)
    counts["lm smoke"] = lm_smoke(torch, rec)
    rec["phase_s"]["lm"] = time.perf_counter() - t0
    log(f"[lm] phase {rec['phase_s']['lm']:.1f} s")

    # 17. recurrent: whisper-base, xlstm-125m and zamba2-2.7b at full width
    # (a Mamba2 block's scan route held to the chunk loop first), the three
    # smoke keys through the trainer
    from repro_torch.configs.smoke import RECURRENT_FACTORIES
    t0 = time.perf_counter()
    for arch, phase in (("whisper-base", recurrent_whisper),
                        ("xlstm-125m", recurrent_xlstm)):
        left = release(torch)
        if left >= 1e9:
            fail(f"recurrent {arch}: {left / 1e9:.2f} GB still allocated; "
                 "the previous phase was not released")
        counts[f"recurrent {arch}"] = phase(torch, rec, smi_line)
    release(torch)
    mamba2_block_parity(torch, rec)
    left = release(torch)
    if left >= 1e9:
        fail(f"recurrent zamba2-2.7b: {left / 1e9:.2f} GB still allocated")
    counts["recurrent zamba2-2.7b"] = recurrent_zamba2(torch, rec, smi_line)
    release(torch)
    counts["recurrent smoke"] = lm_smoke(torch, rec, RECURRENT_FACTORIES,
                                         "recurrent")
    rec["phase_s"]["recurrent"] = time.perf_counter() - t0
    log(f"[recurrent] phase {rec['phase_s']['recurrent']:.1f} s")

    # 18. serve: prefill and decode through the KV caches and states, the
    # four full-width models, then the smoke keys card vs CPU
    t0 = time.perf_counter()
    for arch, phase in (("smollm-360m", serve_smollm),
                        ("whisper-base", serve_whisper),
                        ("xlstm-125m", lambda t, r, sl: serve_recurrent(
                            t, r, "xlstm-125m", sl)),
                        ("zamba2-2.7b", lambda t, r, sl: serve_recurrent(
                            t, r, "zamba2-2.7b", sl))):
        left = release(torch)
        if left >= 1e9:
            fail(f"serve {arch}: {left / 1e9:.2f} GB still allocated; the "
                 "previous phase was not released")
        counts[f"serve {arch}"] = phase(torch, rec, smi_line)
    release(torch)
    counts["serve smoke"] = serve_smoke(torch, rec)
    rec["phase_s"]["serve"] = time.perf_counter() - t0
    log(f"[serve] phase {rec['phase_s']['serve']:.1f} s")

    # 19. registry: every bundle through get_arch; smollm-360m (pp_wave) and
    # internlm2-20b (pp_1f1b) on their own plans, qwen3-moe with int8
    # moments, a smollm serve step, each through train/steps.py
    t0 = time.perf_counter()
    registry_bundles(torch, rec)
    for what, phase in (("smollm-360m", registry_smollm),
                        ("internlm2-20b", registry_internlm2),
                        ("qwen3-moe-30b-a3b int8", registry_qwen3_int8),
                        ("serve", registry_serve)):
        left = release(torch)
        if left >= 1e9:
            fail(f"registry {what}: {left / 1e9:.2f} GB still allocated; "
                 "the previous phase was not released")
        c = phase(torch, rec, smi_line)
        if what == "qwen3-moe-30b-a3b int8":
            c = {"registry qwen3-moe-30b-a3b int8": c}
        elif what == "serve":
            c = {"registry smollm-360m serve": c}
        counts.update(c)
    release(torch)
    rec["phase_s"]["registry"] = time.perf_counter() - t0
    log(f"[registry] phase {rec['phase_s']['registry']:.1f} s")

    # 12. ranks: one process per pipeline device, four on the one card
    left = release(torch)
    if left >= 1e9:
        fail(f"ranks: {left / 1e9:.2f} GB still allocated; the previous "
             "phase was not released")
    t0 = time.perf_counter()
    counts["ranks"] = ranks_phase(torch, rec, smi_line)
    rec["phase_s"]["ranks"] = time.perf_counter() - t0

    # 12b. lm ranks: smollm-360m over four ranks, P=2 x dp=2 ZeRO-2
    left = release(torch)
    if left >= 1e9:
        fail(f"lm ranks: {left / 1e9:.2f} GB still allocated; the previous "
             "phase was not released")
    t0 = time.perf_counter()
    counts["lm ranks"] = lm_ranks_phase(torch, rec, smi_line)
    rec["phase_s"]["lm ranks"] = time.perf_counter() - t0

    # 12c. sharded ranks: the SDv2 UNet's train_4k plan and whisper-base's
    # prefill and decode plans over a (data=2, model=2) grid of ranks
    left = release(torch)
    if left >= 1e9:
        fail(f"sharded ranks: {left / 1e9:.2f} GB still allocated; the "
             "previous phase was not released")
    t0 = time.perf_counter()
    counts["sharded ranks"] = sharded_ranks_phase(torch, rec, smi_line)
    rec["phase_s"]["sharded ranks"] = time.perf_counter() - t0

    # 13. hybrid: the tuner's N=4 plan, two data replicas, ZeRO-1 and 2
    left = release(torch)
    if left >= 1e9:
        fail(f"hybrid: {left / 1e9:.2f} GB still allocated; the previous "
             "phase was not released")
    import shutil
    ckdir = os.path.join(ROOT, "build", "chip_smoke_rank_ckpt_dir")
    shutil.rmtree(ckdir, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        hybrid_counts, save_docs = hybrid_phase(torch, rec, smi_line, ckdir)
        counts.update(hybrid_counts)
        rec["phase_s"]["hybrid"] = time.perf_counter() - t0

        # 14. checkpoints over ranks: the ZeRO-2 world's save, resumed
        # elastically as four pipeline ranks
        t0 = time.perf_counter()
        counts["rank checkpoint"] = rank_checkpoint_phase(
            torch, rec, smi_line, ckdir, save_docs)
        rec["phase_s"]["rank checkpoint"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    # 11, run last: the supervisor over ranks (its UViT-H part holds its
    # losses to the hybrid phase's)
    left = release(torch)
    if left >= 1e9:
        fail(f"supervisor: {left / 1e9:.2f} GB still allocated; the "
             "previous phase was not released")
    t0 = time.perf_counter()
    counts["supervisor ranks"], counts["host workers"] = supervisor_phase(
        torch, rec, smi_line)
    rec["phase_s"]["supervisor"] = time.perf_counter() - t0
    log(f"[supervisor] phase {rec['phase_s']['supervisor']:.1f} s")

    # 15. results: each kernel's numbers at the Hunyuan-DiT train step's
    # shape (the scan: zamba2's carry across chunks), every train path's
    # beside them, and its launches on every path
    kernels = []
    for kname, (source, replaces) in SOURCES.items():
        by_path = {path: c[kname] for path, c in counts.items()}
        if kname == "gated_linear_scan":
            row = main_rows[kname]
            by_shape = {f"{r['shape']} {r['direction']} {r['dtype']}": r
                        for r in rec["gated_linear_scan"]}
        else:
            row = main_rows[kname]["hunyuan-dit"]
            by_shape = main_rows[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "device_ms": row["device_ms"],
            "library_device_ms": row["library_device_ms"],
            "launches_by_path": by_path,
            "by_shape": {k: {f: r.get(f) for f in (
                "dtype", "route", "max_abs_err", "rel_err_vs_fp32", "ms",
                "device_ms", "device_tflops", "plain_ms", "plain_device_ms", "bound_ms",
                "bound_by", "library_ms", "library_device_ms")}
                for k, r in by_shape.items()}})
    rec["kernels"] = kernels
    rec["wall_s"] = time.perf_counter() - t_start
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(rec, f, indent=1)
    log(f"[done] {rec['wall_s']:.1f} s; phase s "
        f"{ {k: round(v, 1) for k, v in rec['phase_s'].items()} }")
    log(smi_line)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
