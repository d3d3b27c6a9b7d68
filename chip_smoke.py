#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (vitgan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Fails unless torch.cuda.is_available(); prints the card's name and power
   limit as nvidia-smi gives them.
2. Builds the hand-written CUDA kernels from vitgan_tpu_torch/ops/csrc, all
   sources in parallel, timed, and prints every ptxas performance warning
   (C7xxx) with its kernel, recorded in the kernels' entries; where the
   toolkit has cuobjdump, counts the wgmma (HGMMA) and TMA (UTMALDG)
   instructions of the sources redesigned for Hopper (wgrad_gemm, the flash
   forward, the k-block backward, the q-block dq, the LN->MLP forward,
   LN->qkv and the megablock backward's MLP and LN1 halves) and fails on
   none, and the HGMMA of each persistent `l2` kernel (the forward, the
   single pass, dq and dk/dv, fed by 1-D bulk copies, no tensor map); fails
   where one of those kernels spills or draws a ptxas performance warning at
   DP 112 or 64.
3. Holds every kernel against its plain PyTorch version on the same bf16
   inputs on the card: at the serving shapes of highres128 at batch 64, at a
   ragged shape (N 257, E 192, 3 heads) and, for flash attention, at one long
   sequence (B*H 1, N 16,385) and with O written in the (B, N, H*D) layout.
   Times kernel, plain version and, where one PyTorch call computes the same
   function, that call (library_ms); the LN->MLP forms and LN->qkv also
   bit-equal across two calls, with their device time by the profiler
   (LN->qkv beside torch.matmul of its product).
4. Writes a highres128 run directory with seeded random weights, starts the
   HTTP server on 127.0.0.1:0 and serves batch-64 requests through the
   default (megablock) route: png, npy, a byte-equal seeded repeat and
   coalesced unseeded requests, plus /healthz and /metrics.  Every kernel of
   the route must have launched 12 times per device call.
5. Runs the generator on one latent batch through the megablock route, the
   megablock=off route (flash + LN->MLP kernels) and the all-plain route, in
   bf16, and the all-plain route in f32, and holds each against the others.
6. Serves the same weights from a run directory whose config sets
   runtime.megablock=off: one seeded npy request over HTTP, whose flash and
   LN->MLP kernels must have launched 12 times per device call, held against
   the megablock route's answer to the same request.
7. Holds the three flash-attention backward kernels (single-pass, dq, dk/dv)
   against their plain versions at the generator's shape (32, 6, 1024, 64),
   the discriminator's (64, 6, 1025, 64), a ragged (2, 3, 257, 64), a long
   (1, 1, 16385, 64) shape and highres256p4's G (8, 6, 4096, 64) and D
   (16, 6, 4097, 64), each output within 2e-2 of its own max|plain|
   and bit-equal across two calls (dq of the single pass too);
   times each beside its bound, its plain version and PyTorch's
   scaled_dot_product_attention backward (library_ms), and at its main
   shape splits the wrapper's device time into its own kernels' and the
   rest (the PyTorch delta = rowsum(dO * O) when none is given).
8. Holds the megablock's training kernels against their plain versions at
   G's (32, 1024, 384, 6 heads, hidden 1536), D's (64, 1025, ...), a ragged
   (2, 257, 192, 3 heads, hidden 768) and deit64's D update (128, 257, 192,
   ...) shape: LN->qkv (its output in (3, B, H, N, Dh) with rows that
   straddle samples; two calls bit-equal, its device time by the profiler,
   beside torch.matmul of its product), the training form of ln_mlp_fwd
   (dropout masks bit-equal to the plain Philox's; out, x1, z1 by
   KERNEL_RTOL), megablock_bwd_mlp (with and without dropout; two calls
   bit-equal, its device time by the profiler; each of its three stage kernels against its stage plain
   version, with its device time and bound), megablock_bwd_ln1 (dx, its
   LN1^T(dy1) term, y1 and the dln1 partials of each 64-row tile row for
   row, their sum_partials against the plain sum; two calls bit-equal, its
   device time, beside torch.matmul of its product), wgrad_gemm
   (beside torch.matmul of the same A^T.B; two calls bit-equal) and sum_partials
   (each output within KERNEL_RTOL * its own max|plain|; sum_partials
   bit-equal to its order model and across two calls, its device time and
   part.sum(0)'s by the profiler), then one block's whole saved-residual
   backward against autograd of the plain masked block in f32: dx and each
   of the 12 parameter gradients within MB_GRAD_RTOL * its own max|plain|.
   Then the LN->MLP forward stage by stage at the serving, G's, D's and a
   ragged shape: its two stage kernels against their stage plain versions
   (the linear stage as the out-projection and as fc2, with bit-equal
   masks, and LN -> fc1 -> GELU with z1), the three forms against their
   whole plain versions and bit-equal across two calls, and at each form's
   main shape torch.matmul of the same products ("products only").
9. Under the default runtime.megablock=auto a highres128 training block at
   1,024 and 1,025 tokens takes encoder_block_fused_dropout_saved (the JAX
   package's gate); with megablock_bwd=recompute or megablock=off the
   standard path.
10. Trains highres128 under the preset's default runtime (megablock=auto,
   megablock_bwd=saved) through Trainer (the entry point of `cli train`) on a
   256-sample synthetic dataset at batch 32 in bf16 with dropout 0.1 and
   DiffAugment color,translation: 2 eager warm-up steps, 3 eager steps timed
   (the eager step beside the captured one), a warm-up epoch of 5 steps (its
   first step runs eagerly and is captured as a CUDA graph), then a timed
   epoch of 5 captured steps by Trainer.fit, whose kernel launches per step
   are asserted (TRAIN_KERNELS: the megablock's training forward and saved
   backward in every block, no LN->MLP; counted at the capture and added per
   replay) beside the epilogue's sample grid.  The losses must be finite and
   the parameters must have moved; torch.profiler splits one captured call's
   device time by kernel group.  The run directory fit writes is restored by
   restore_run, answers one `cli generate` and one HTTP request of the
   server `cli serve` starts.  Then the same with runtime.megablock=off
   (flash forward 36, single-pass backward 12, dq 24, dk/dv 24, LN->MLP 36 a
   step), whose breakdown adds the LN->MLP recompute backward alone.
11. Trains deit64 at full width under megablock=auto, 1 eager step, a
   warm-up epoch of 3 and 3 captured steps: the megablock's training kernels
   at 256 and 257 tokens, E 192.
12. Runs one train step at full width and batch 8, dropout 0, with the same
   state, batch, latents and augment draws, on the megablock=off kernel
   route, the megablock=auto route (twice) and use_pallas=never, and holds
   losses, gradient norms and every gradient leaf of each kernel route to the
   plain one; reports which gradient leaves of the two auto steps are not
   bit-equal.
13. Holds the `l2` and `l2ref` flash forward (output and LSE) and the `l2`
   dq, dk/dv and single-pass kernels against their plain versions at the v1
   discriminator's shape (256, 4, 50, 108), at 64 and 65 tokens (one tile
   exactly, one row past it), a ragged (4, 4, 1025, 108) and (8, 6, 1024,
   64), with the forward and backward limits above, every output contiguous
   at the unpadded head width; times each
   beside its bound, its plain version and, for `l2`, scaled_dot_product_
   attention with the -inv |k|^2 key mask (the same softmax but for the
   clamp; library_ms, timed only) and, at the discriminator's shape, the
   device time of each wrapper's own kernels and of its other work (delta,
   and a parent tree's pads); each backward kernel's outputs bit-equal
   across two calls.  Then
   the `dot` forward and single-pass backward at the v1 generator's shape
   (128, 4, 32, 96), scale 384, with the same limits, the single pass
   bit-equal across two calls.
14. [train v1 captured]: trains the v1 ViTGAN at the reference defaults
   (batch 128, latent 1,024, G hidden 384 depth 4, D 50 tokens width 432
   depth 4 with ISR) under runtime.use_pallas=always through Trainer.fit on
   the device-data route, 3,072 samples (24 steps an epoch): 2 eager warm-up
   steps, 5 eager steps timed, a warm-up epoch (the capture), then a timed
   epoch of 24 captured steps: ms/step beside the eager step's, img/s, peak
   memory, the launches per step held to eager's (V1_KERNELS: every
   attention on a kernel, `l2` forward and two-pass backward in D) with no
   plain attention over the capture and the timed epoch, a profiled
   breakdown of a captured call (device busy per step, idle share); restores
   the run directory, runs `cli generate` and serves one HTTP request from
   it.  Then a warm-up epoch and 3 captured steps with
   runtime.bwd_fusion=fused, whose D backward takes the `l2` single pass,
   and a profiled breakdown of a captured call.
15. Runs one v1 train step at batch 8, dropout 0, from the same state,
   batch and latents on use_pallas=always (both backward routes, bf16) and
   use_pallas=never (bf16 and f32): losses, gradient norms, every gradient
   leaf (a scalar leaf against the sum of its per-sample terms' magnitudes)
   and the ISR u buffers after the step of each kernel route held to the f32
   plain route (the bf16 plain route's own distance printed beside); under
   'auto' the step launches no kernel (the JAX decision at 32 and 50
   tokens).
16. Drives the `l2ref` route, an ISR attention of the v1 discriminator's
   width under use_pallas=always, forward and backward: the forward kernel
   once, the backward by autograd of the plain chunked recompute (the JAX
   package's, which has no kernel for it).
17. [captured vs eager]: from one state, batch order, latent block and
   generator state, n = 4 captured v1 steps (use_pallas=always) and n = 2
   captured highres128 steps (megablock=auto, dropout and DiffAugment)
   against as many eager make_train_step calls: every leaf's change within
   LEAF_RTOL of the eager change's max |.|, unchanged leaves, the counters
   and the generator state bit-equal, ISR u within U_TOL, losses within
   LOSS_TOL, norms within NORM_RTOL; prints max |d| per leaf group and
   whether the routes are bit-equal.
18. [resume]: v1 at 2 steps an epoch, 2 epochs uninterrupted twice, and 1
   epoch, its checkpoint, a fresh Trainer's resume() and the second epoch:
   bit-equal where the two uninterrupted runs are, else within their spread.
19. [optimizer]: one update of the port's Optimizer over highres128's 144.6 M
   parameters with torch.optim's fused and foreach AdamW in turns, beside
   its byte bound.
20. [eval]: the port's InceptionV3 at 299 px (random_torch_state_dict(0)
   weights through $INCEPTION_WEIGHTS) and the random-conv extractor on the
   card against the same modules on the CPU, in f32 (features and logits
   within 1e-3, the random conv within 1e-4, of max(1, max|CPU|)), the
   Inception forward timed at batch 64; the on-device FID's moments against
   the host's FeatureStats on the same features (rtol 1e-3, atol 1e-4);
   highres128 through Trainer with FID every epoch at the preset's 2,560
   samples and the `inception` extractor: both FIDs finite, the best
   checkpoint and generator_best.pt written, one evaluate_fid launching
   exactly n_batches (80) serving calls' kernels, its seconds split into the
   generator, the Inception features and the host's Frechet math; then `cli
   generate --best` and `cli eval --best` (FID, KID, precision/recall and
   the Inception Score).  Every fit-driven phase before it trains with
   run.fid_every_epochs=0.
21. [data]: writes CIFAR-10's python archive from seeded numpy (five
   data_batch pickles of 10,000 images and test_batch, as a directory and as
   cifar-10-python.tar.gz), a 5,000-image CIFAR set and MNIST's IDX files
   (60,000 plain, 10,000 gzipped), timed; decodes them (the archive
   byte-equal to the directory) and resizes CIFAR-10 32 -> 128 px, held to
   the C++ path (numpy bit-equal on 64 images).  Trains highres128 at its
   defaults over that set (50,000 x 128 x 128 x 3 = 2.46 GB, over
   data.on_device_max_bytes): the host route with the native assembler, a
   warm-up epoch, a timed epoch of DATA_STEPS captured steps by fit
   (launches per step asserted, TRAIN_KERNELS["auto"]), a profiled epoch
   (device busy, idle share), the pipeline's host ms per batch (assembly,
   copy issue), the copies' device time and the consumer's waits; one
   host-route FID (reals from a pipeline epoch, random conv, 2,560 a side)
   with its seconds, split and launches (80 serving calls').  Then the same
   on the device route (the limit raised, the same seed): the same orders,
   the host's batches bit-equal to the device's gathers, launches a step
   equal, the states after 3 x DATA_STEPS steps bit-equal or within the
   captured-against-eager bounds (printed which), the host-to-device step
   ratio.  Then v1 at its defaults with drop_last=False over the 5,000
   images: 39 batches of 128 and one of 8, all trained in one epoch.
22. [double backward]: a v2 model at highres128's widths (embed 384, 6 heads of
   64, hidden 1,536, depth 12, latent 256) on 32 px images at patch 4 (64
   tokens, 65 in D), batch 64, dropout 0.1, bce, R1 (gamma 10) every second
   step, through Trainer's dataset and the captured make_device_data_train_fn
   on two routes: megablock=off (every MLP through the LN->MLP Function at
   4,096 and 4,160 rows; attention on the plain route below 256 tokens) and
   megablock=on with megablock_bwd=recompute (every training block through
   encoder_block_fused_dropout).  R1 differentiates them twice: their forward
   launches the kernels, their backward is autograd of the plain versions.
   Per route: the eager and captured step times with and without R1, d_r1,
   the launches a step of each kind (every block of every forward, no
   backward kernel).  Then one R1 step (dropout 0) from one state, batch,
   latents and augment draws on each route against use_pallas=never at the
   route comparison's bounds, d_r1 within NORM_RTOL.
23. [int8 serve]: the [serve] run directory served with float weights and
   with weight-only int8 (serve.SamplerService(quantize="int8"): the int8
   leaves and scales on the card, the module's float weights gone, each call
   dequantizing into bf16) at batch 64 on the megablock route: weight bytes,
   call time, launches equal to the float route's, the seeded uint8 drift
   within the JAX package's bounds (mean 4, p99 24 levels).
24. [interop]: highres128's discriminator written as a reference v2
   ViTDiscriminator state_dict ('vit.' keys, a 10-class head) from seeded
   numpy; `cli train --preset highres128 --warm-start-d` on it (every D leaf
   loaded, bit-equal to the import; a warm-up epoch of 3 steps and 3 captured
   steps through the megablock's training kernels, launches asserted, the
   step time); `cli export-torch` of the trained D re-imported bit-equal.
25. [baselines]: dcgan, cnn and mlp at their default configs (32 px; batch
   128, 64, 128; DCGAN base width 64; MLP hidden 256/512/1024) on synthetic
   data through Trainer: an eager step timed, a warm-up epoch of 3 (the
   capture), 3 captured steps by fit (no hand kernel: cuDNN convolutions,
   BatchNorm in f32, dense products), their captured steps against eager
   ones in [captured vs eager]'s terms; for dcgan and cnn `cli export-torch`
   of G and `cli generate --from-torch`.

26. [highres256p4]: the 4,096-token preset at full width (256 px at patch 4,
   4,096 tokens and 4,097 in D, embed 384, 6 heads, depth 12, batch 8, remat
   'attn', dropout 0.1, DiffAugment) through Trainer on 64 synthetic images:
   1 eager warm-up step, 2 eager steps timed, a warm-up epoch of 3 (the
   capture), a timed epoch of 3 captured steps by fit after _settle: ms/step,
   peak memory, launches a step (flash forward, single pass and LN->MLP in
   every block, nothing else), a profiled breakdown with the idle share; 2
   captured steps against 2 eager ones ([captured vs eager]); one step from
   the same state on the kernel route and on use_pallas=never, held in the
   route comparison's bounds (D's head bias at its per-sample scale).
27. [remat]: highres256p4 under never, full, dots and attn, highres128 under
   never and its preset's attn, each from one state: a call of 3 steps (the
   capture), then 3 replays timed; ms/step, peak, launches a step held to
   train_kernels (the megablock's forward or, under full and dots, the flash
   forward re-run once a block), the state after 6 steps against never's.
28. [grad accum]: highres128 with grad_accum 2 on G and D and an EMA: 4
   captured steps against 4 eager ones across accumulation boundaries, and a
   run resumed after 3 steps (mid-accumulation) against 6 uninterrupted:
   bit-equal.
29. [bench]: `cli bench --preset highres256p4 --scan 3 --iters 2 --flops`:
   images/s within 5% of [highres256p4]'s captured step, the FLOP model's
   GFLOP a step and the TFLOP/s it sustains.
30. [cli]: `cli doctor` exits 0; `cli warmup v2` with the kernels built: its
   seconds, beside the script's first build, which is `cli warmup v2` on an
   empty build directory (every source built).
31. [sweep]: `cli sweep` at the reference search space's widths (32 px,
   depth 6, embed 128-512, batch 128/256) on synthetic data, cut to
   SWEEP_CUTS (steps an epoch, FID samples): 4 trials of seed SWEEP_SEED as
   two workers sharing one JSONL (--trial-stride 2, offsets 0 and 1), each
   trial's seconds and launches per kernel (a trial whose MLPs pass the
   LN->MLP gate launches its stage kernels, the embed-512 trial the wide
   LN->fc1 among them, and one that fails it none), best_config.json, the last worker's
   ranking over all four, `--resume` skipping every trial and ranking
   alike; then `--vectorize`'s group of 4 trials at the widest shape (embed
   512, 8 heads, batch 256; the sampler patched to 4 rates): its ms to step
   all four against the in-place plain step's, the peak memory, and a
   one-trial group against the in-place plain step from one state over two
   steps: metrics and the first step's Adam moments within VEC_TOL, the
   parameters within Adam's sign-flip bound, bit-equal counts printed.
32. [parallel]: the linear stage's dropout bits keyed by the global row (a
   rank's rows of D's [real; fake] batch) against the plain version; then
   highres128 under auto as a captured fit (an epoch of 3 steps, the
   capture, and one of 3 replays) with no mesh, then in a world-1 NCCL
   group over a FileStore under a DP mesh, under FSDP and under TP (the
   plan kept on the one-rank axes: the placement's gathers and reduces
   run): each state bit-equal to the no-mesh fit's (FSDP and TP, where not,
   within the route bounds, the reason printed), the
   launches a step per kernel equal, the NCCL kernels inside the replay
   (profiler: at one rank NCCL's averaging all-reduce runs its
   oneRankReduce kernel; its all-gathers and reduce-scatters are copies),
   ms a step and the peak memory.  No multi-rank run: the machine has one
   card.
35. [wide kernels] (after the megablock's kernels): each wide variant's
   launch (E > 384: the LN rows, the streamed fc1 and qkv products, the
   dmlp rows, the streamed dz1 and dao products, dy = a . w^T in f32, the
   LN-backward rows of the dx1 stage and of the LN1 half) against its plain
   version at DeiT-B's G (64 x 256 rows, E 768, hidden 3,072) and D (64 x
   257) shapes, forwards by KERNEL_RTOL * max(1, max|plain|), the
   backward's outputs by KERNEL_RTOL * their own max|plain|, each bit-equal
   across two calls, timed beside its plain version, its bound, F.layer_norm
   (the LN rows' library call) and torch.matmul of its products; the four
   forms whole timed beside their bounds; each form forced wide at
   highres128's G shape against the resident kernels, the largest
   difference printed.
36. [train deit64 wide] (after [train deit64]): deit64 with --set
   v2.embed_dim=768 v2.num_heads=12 (DeiT-B's widths) at full depth and
   batch 64 under megablock=auto through Trainer.fit: a capture epoch, then
   WIDE_STEPS captured steps after _settle, launches a step asserted
   (wide_train_kernels: every block of G and D on the wide variants), a
   profiled breakdown, ms/step and peak; one batch-64 serving call; one
   eager step at dropout 0 against use_pallas=never in the route bounds.  The
   wide kernels' `launches` in the JSON line are this path's.
37. [f32 kernels] (after [wide kernels]): the f32 flash kernels
   (csrc/flash_f32.cuh: the forward in `dot`, `l2` and `l2ref` and dq in
   `dot` and `l2` on mma.sync; csrc/flash_f32_bwd.cuh: the single pass and
   dk/dv in `dot` and `l2` on TF32 wgmma) at the v1 generator's (128, 4, 32,
   96) and discriminator's (256, 4, 50, 108) shapes, highres128's G (32, 6,
   1024, 64) and D (32, 6, 1025, 64), highres256p4's G (8, 6, 4096, 64) and
   D (16, 6, 4097, 64), a ragged (4, 4, 65, 108) in every mode and one head
   of 16,385 tokens,
   against their plain versions in full f32: a forward output within
   F32_RTOL * max(1, max|plain|), the LSE within F32_LSE_TOL, a backward
   output within F32_RTOL * its own max|plain|, each at most half the bf16
   kernel's error on the same inputs cast to bf16, the backward's outputs
   bit-equal across two calls; timed beside the TF32 bound, the plain
   version, SDPA in f32 (`dot`, `l2` with its key mask) and the device time
   of the wrapper's own kernels.  The SASS of the forward's and dq's sources
   must hold TF32 tensor-core products (HMMA); the single pass's and dk/dv's
   TF32 HGMMA with UTMALDG and no HMMA, in each instantiation of the k-block
   kernel too.
38. [ln_mlp activations]: the fc1 stage with gelu, relu, tanh and sigmoid at
   highres128's serving rows (E 384, resident) and DeiT-B's G rows (E 768,
   wide) against its plain version within KERNEL_RTOL, bit-equal across two
   calls, each timed beside GELU's.
39. [train v1 f32] (after [train v1 captured] and its routes): the v1
   ViTGAN at the reference defaults with runtime.compute_dtype=float32 under
   use_pallas=always through Trainer.fit (a capture epoch, then 8 captured
   steps, launches a step held to V1_F32_KERNELS: only f32 flash kernels, no
   plain attention), a profiled breakdown, one HTTP request to its run
   directory; captured against eager, bit-equal; one dropout-0 step on
   bwd_fusion auto, fused and two_pass against use_pallas=never in f32 within
   F32_LOSS_TOL, F32_NORM_RTOL and F32_LEAF_RTOL, which the control route
   (the f32 model on the bf16 flash kernels) must miss; the `l2ref` route in
   f32.  The f32
   kernels' `launches` in the JSON line are this path's (the `l2` single
   pass, `dot` dq and dk/dv and `l2ref` from their one-step routes).
40. [f32 ln kernels] (after [f32 kernels]): the LayerNorm family's f32
   entries (csrc/ln_f32.cuh on tile_f32.cuh's TF32 wgmma tile: LN -> fc1
   with z1, the linear stage as fc2 with the residual and a 0.1 mask, LN1 ->
   qkv) at highres128's serving, G and
   D rows, highres256p4's G, DeiT-B's G (E 768) and a ragged deit64 batch
   against their plain versions in full f32: each output within F32_RTOL *
   max(1, max|plain|) and at most half the bf16 kernel's error on the same
   inputs, bit-equal across two calls, the f32 mask bit-equal to the plain
   and the bf16 stage's; timed beside the TF32 bound, the plain version and
   F.layer_norm + torch.matmul in f32 and in TF32 (SASS: TF32 HGMMA with
   UTMALDG, no HMMA); the f32 flash forward's (B, N, H*Dh) layout bit-equal
   to its (B, H, N, Dh) output.
41. [v2 f32] (after [train v1 f32]): runtime.compute_dtype=float32 on the v2
   presets under use_pallas=auto.  highres128 served at batch 64 over HTTP
   through the megablock's f32 forward (launches held to V2_F32_SERVE a
   block, no bf16 LayerNorm or flash launch), beside [serve]'s bf16 run
   directory (the same weights); a DeiT-B-width serving call (E 768);
   highres128 through Trainer.fit under megablock=on, megablock_bwd=recompute
   at dropout 0.1 (a capture epoch, then V2_F32_STEPS captured steps,
   launches a step V2_F32_KERNELS["recompute"]), captured against eager
   (bit-equal); one dropout-0 step at depth 12 on megablock=on/recompute,
   on it with a full-f32 backward, on megablock=off and on the bf16-fed
   control against use_pallas=never in f32 within V2_F32_LOSS_TOL,
   V2_F32_NORM_RTOL and V2_F32_LEAF_RTOL (the control must miss one; the v1
   f32 bounds' misses reported); then, after [remat], highres256p4 at its
   preset in f32 on that phase's trainer, P4_F32_STEPS captured steps on the
   standard path.  The f32 LayerNorm entries' `launches` in the JSON line are
   the highres128 recompute fit's.  Since the saved backward has f32 kernels
   ([f32 bwd kernels]): highres128 at its preset with only
   runtime.compute_dtype=float32 (megablock=auto, megablock_bwd=saved,
   dropout 0.1, remat attn) through Trainer.fit, launches a step held to
   V2_F32_KERNELS["saved"] (no bf16 kernel, no recompute backward), captured
   against eager (bit-equal), its device time by kernel group (the port's f32
   kernels under their own labels) and the K-major weight copies' ms a step
   (kmajor_copy_ms); deit64 at its preset in f32, one captured step;
   the saved route and its bf16-fed backward control among the dropout-0
   route steps.  The saved backward's f32 entries' `launches` in the JSON
   line are the highres128 preset fit's.
42. [f32 bwd kernels] (after [f32 ln kernels]): the saved backward's f32
   entries (csrc/tile_f32.cuh's products: dz1 with h1, dy2 and dy1, dao
   with delta; wgrad_gemm_f32's A^T . B over stages re-laid K-major on
   chip; ln_rows.cuh's rows on f32: dmlp = g * m2, the
   LN2 and LN1 backward) at highres128's G and D rows, deit64's ragged batch
   and DeiT-B's G against their plain versions in full f32: each output
   within F32_RTOL * max(1, max|plain|), at most half the bf16 kernel's
   error on the same inputs, bit-equal across two calls; timed beside the
   TF32 bound, the plain version and torch.matmul of the products in TF32
   (SASS: the A . W^T tile's three sources and wgrad_gemm_f32 TF32 HGMMA
   with UTMALDG and no HMMA).
Highres128's preset sets runtime.remat='attn' (the JAX preset's): every phase
that trains it re-runs the megablock's training forward once a block in the
backward, and its launches a step are taken from train_kernels.

Any failed check raises.  The second-to-last lines are a {"kernels": [...]}
JSON object and nvidia-smi's name/power line; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import io
import json
import math
from collections import Counter
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

SEED = 0
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
# Forward kernel vs plain version, both bf16 out: |kernel - plain| <=
# KERNEL_RTOL * max(1, max|plain|); a backward kernel's output, whose values
# lie well under 1, within KERNEL_RTOL * max|plain| of its own.  The kernels
# round the LN output, the GELU output and the softmax probabilities (in the
# backward P and dS) to bf16 before the next product, where the plain
# versions keep f32, and both round the result to bf16 (2**-8 relative).
# Where the output carries the residual x, the relative part scales with
# max|plain - x| (the block's own term, so a dropped bias or product shows)
# plus one bf16 unit in the last place of max|plain| (BF16_ULP relative): the
# two outputs are rounded to bf16 independently.
KERNEL_RTOL = 2e-2
BF16_ULP = 2.0 ** -7
# Generator routes, images in [-1, 1]: bf16 activations round differently on
# each route over 12 blocks.  Bounds: max |d| <= 0.0625, mean |d| <= 0.01.
IMAGE_MAX_TOL, IMAGE_MEAN_TOL = 0.0625, 0.01
# Train step, kernel route against the plain route, both bf16, from one state
# on one batch: the kernels round P, dS, the LN output and the GELU output to
# bf16 where the plain versions keep f32, through 12 blocks of G and of D and
# back.  Losses within LOSS_TOL absolute; gradient norms within NORM_RTOL
# relative; every gradient leaf within LEAF_RTOL * max|plain leaf|.
LOSS_TOL, NORM_RTOL, LEAF_RTOL = 2e-2, 5e-2, 1e-1
# The same in f32: the kernel routes' TF32 products (a 10-bit mantissa)
# against the plain route in full f32, through 4 blocks of G and of D.  The
# route control F32_CONTROL, the f32 model whose flash kernels run in bf16 on
# its attention's inputs rounded to bf16, must miss one of these bounds: they
# see an attention that rounds through bf16.  On an H100 the f32 routes read
# losses within 1.5e-5, norms 9e-6, leaves 4.9e-4; the control 1.8e-4 to
# 2.4e-4, 4.7e-5, 4.9e-3.
F32_LOSS_TOL, F32_NORM_RTOL, F32_LEAF_RTOL = 1e-4, 1e-4, 2e-3
F32_CONTROL = "bf16_flash_control"
# The ISR u vectors (unit vectors) after one v1 step, kernel route against
# the plain one: max |d| within U_TOL.
U_TOL = 1e-3


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int, kernels: tuple) -> tuple:
    """Device time per call of ``fn`` under torch.profiler over ``iters``
    calls: (the kernels whose CUDA symbols hold one of ``kernels``, every
    other device operation of the call: the wrapper's pads, copies, memsets
    and reductions).  (None, None) where the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    own = other = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = e.self_device_time_total / 1e3 / iters
            if any(k in e.key for k in kernels):
                own += t
            else:
                other += t
    return (own, other) if own > 0 else (None, None)


def _bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _err(got, want, what: str, residual=None, own_scale: bool = False) -> float:
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    err = (got.float() - want.float()).abs().max().item()
    peak = want.float().abs().max().item()
    if own_scale:
        tol = KERNEL_RTOL * peak
    elif residual is None:
        tol = KERNEL_RTOL * max(1.0, peak)
    else:
        own = (want.float() - residual.float()).abs().max().item()
        tol = KERNEL_RTOL * max(1.0, own) + BF16_ULP * peak
    print(f"  {what}: max_abs_err {err:.6g} (tolerance {tol:.6g}, max|plain| {peak:.6g})")
    if not err <= tol:
        raise AssertionError(f"{what}: kernel disagrees with its plain version")
    return err


def _case(b, n, e, heads, hidden, gen):
    """bf16 inputs of one encoder block on the card, JAX layouts.  Biases and
    LN parameters are drawn at 0.1, so that a kernel that dropped one would
    exceed its tolerance."""
    import torch

    dev, dh = "cuda", e // heads

    def rn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(dtype)

    f32 = torch.float32
    return dict(
        x=rn(b, n, e), q=rn(b, heads, n, dh), k=rn(b, heads, n, dh), v=rn(b, heads, n, dh),
        attn=rn(b, n, heads * dh),
        ln_s=1.0 + rn(e, scale=0.1, dtype=f32), ln_b=rn(e, scale=0.1, dtype=f32),
        qkv_w=rn(3, heads, e, dh, scale=0.02), qkv_b=rn(3, heads, dh, scale=0.1, dtype=f32),
        wout=rn(heads * dh, e, scale=0.02), bout=rn(e, scale=0.1, dtype=f32),
        w1=rn(e, hidden, scale=0.02), b1=rn(hidden, scale=0.1, dtype=f32),
        w2=rn(hidden, e, scale=0.02), b2=rn(e, scale=0.1, dtype=f32),
        dims=(b, n, e, heads, dh, hidden))


def _ptxas_kernels(log: str) -> list:
    """(mangled name, registers, spill store bytes, spill load bytes) of each
    kernel in an `nvcc -Xptxas -v` log."""
    import re

    out, func, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            func, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and func:
            out.append((func, int(m.group(1)), *spill))
            func = None
    return out


def _ptxas_warnings(log: str) -> list:
    """[(kernel, line)] for every ptxas performance warning (C7xxx: wgmma
    serialised, setmaxnreg ignored, ...) of an `nvcc -Xptxas -v` log, every
    line kept whole; the kernel is the one the line names, else the entry
    function being compiled, else "?"."""
    import re

    out, func = [], "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            func = m.group(1)
        if re.search(r"\(C7\d\d\d\)", line):
            m = re.search(r"function '([^']+)'", line)
            out.append((m.group(1) if m else func, line.strip()))
    return out


# The sources redesigned for Hopper's wgmma and TMA: their SASS must hold
# HGMMA (wgmma) and UTMALDG (TMA tensor load) instructions; the f32 ones on
# TF32 wgmma (csrc/tile_f32.cuh's A . W^T tile: the saved backward's three
# entries and the LayerNorm family's forward; wgrad_gemm_f32.cu's A^T . B
# over stages re-laid K-major on chip; flash_f32_bwd.cuh's k-block kernel:
# the f32 single pass and dk/dv) no HMMA (mma.sync) besides, in every
# function of F32_WGMMA_KERNELS too.
F32_WGMMA_SOURCES = ("megablock_bwd_mlp_dz1_f32", "megablock_bwd_dy_f32",
                     "megablock_bwd_mlp_dao_f32", "ln_mlp_fc1_f32", "ln_mlp_linear_f32",
                     "ln_qkv_fwd_f32", "wgrad_gemm_f32", "flash_attn_bwd_fused_f32",
                     "flash_attn_bwd_dkv_f32")
F32_WGMMA_KERNELS = ("flash_bwd_kv_tf32_kernel",)
HOPPER_SOURCES = ("wgrad_gemm", "flash_attn_bwd_fused", "flash_attn_bwd_dkv", "flash_attn_fwd",
                  "flash_attn_bwd_dq", "ln_mlp_fwd", "megablock_bwd_mlp", "ln_qkv_fwd",
                  "megablock_bwd_ln1", *F32_WGMMA_SOURCES)
# The part of the CUDA symbol of every kernel of ln_mlp_fwd.cu (this tree's
# ln_mlp_fc1_kernel and ln_mlp_linear_kernel, and the single kernel of a
# parent scripts/kernel_ab.py measures).
LN_MLP_SYMBOL = "ln_mlp"
# chip_smoke.py raises where two calls of a kernel whose results must be
# bit-equal are not, and where the `l2` kernels' outputs do not come back
# contiguous at the unpadded head width; scripts/kernel_ab.py sets this False
# to record both on a tree that falls short (a parent whose kernel is not
# bit-deterministic, or whose wrappers slice padded outputs).
STRICT = True


def _repeat(call, what: str) -> list:
    """Calls ``call`` twice; the largest |difference| between the two calls'
    results, one per output (0.0 each: bit-equal).  Raises where the two are
    not bit-equal and STRICT."""
    import torch

    first = call()
    first = first if isinstance(first, tuple) else (first,)
    first = tuple(t.clone() for t in first)
    again = call()
    again = again if isinstance(again, tuple) else (again,)
    torch.cuda.synchronize()
    diffs = [(a.float() - b.float()).abs().max().item() for a, b in zip(first, again)]
    equal = all(torch.equal(a, b) for a, b in zip(first, again))
    print(f"  {what}: {'bit-equal' if equal else 'NOT bit-equal'} across two calls (max |d| "
          f"per output {diffs})")
    if not equal and STRICT:
        raise AssertionError(f"{what}: two calls are not bit-equal")
    return diffs


# The persistent `l2` kernels (csrc/flash_l2.cuh: the forward, the single
# pass, dq and dk/dv), by the part of their CUDA symbols: 1-D bulk copies feed
# them, so their SASS holds HGMMA and no UTMALDG; their instantiations at DP
# 112 (the v1 discriminator's Dh 108) and 64 must neither spill nor draw a
# ptxas performance warning.
L2_KERNELS = ("flash_fwd_l2_kernel", "flash_bwd_fused_l2_kernel", "flash_bwd_dq_l2_kernel",
              "flash_bwd_dkv_l2_kernel")
L2_CHECKED_DP = (112, 64)


def _sass_counts(build) -> dict:
    """{source: {"HGMMA": n, "UTMALDG": n}} from cuobjdump of each library in
    HOPPER_SOURCES, and {symbol: {"HGMMA": n}} of each instantiation of
    L2_KERNELS; {} where the toolkit has no cuobjdump."""
    import re

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        print("[sass] no cuobjdump in the toolkit: not counted")
        return {}
    out = {}
    for name in HOPPER_SOURCES:
        sass = subprocess.run([tool, "-sass", build.lib_path(name)], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        out[name] = {"HGMMA": sass.count("HGMMA"), "UTMALDG": sass.count("UTMALDG"),
                     "HMMA": sass.count("HMMA")}
        print(f"[sass] {name}: {out[name]['HGMMA']} HGMMA, {out[name]['UTMALDG']} UTMALDG, "
              f"{out[name]['HMMA']} HMMA")
        if not (out[name]["HGMMA"] and out[name]["UTMALDG"]):
            raise AssertionError(f"{name} holds no wgmma or no TMA load in its SASS")
        if name in F32_WGMMA_SOURCES and (out[name]["HMMA"] or "TF32" not in sass):
            raise AssertionError(f"{name}: mma.sync left in its SASS, or no TF32 product")
        for func, body in re.findall(r"Function : (\S+)(.*?)(?=Function : |\Z)", sass, re.S):
            if any(k in func for k in L2_KERNELS):
                out[func] = {"HGMMA": body.count("HGMMA")}
                print(f"[sass]   {func}: {out[func]['HGMMA']} HGMMA")
                if not out[func]["HGMMA"]:
                    raise AssertionError(f"{func} holds no wgmma in its SASS")
            if any(k in func for k in F32_WGMMA_KERNELS):
                out[func] = {k: body.count(k) for k in ("HGMMA", "UTMALDG", "HMMA")}
                print(f"[sass]   {func}: {out[func]['HGMMA']} HGMMA, {out[func]['UTMALDG']} "
                      f"UTMALDG, {out[func]['HMMA']} HMMA")
                if not (out[func]["HGMMA"] and out[func]["UTMALDG"]) or out[func]["HMMA"]:
                    raise AssertionError(f"{func}: no wgmma or no TMA load, or mma.sync left")
    for name in build.F32_FLASH:  # mma.sync TF32: the forward and dq
        if name in F32_WGMMA_SOURCES:
            continue
        sass = subprocess.run([tool, "-sass", build.lib_path(name)], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        out[name] = {"HMMA": sass.count("HMMA"), "HMMA_TF32": sass.count("TF32")}
        print(f"[sass] {name}: {out[name]['HMMA']} HMMA ({out[name]['HMMA_TF32']} TF32)")
        if not out[name]["HMMA_TF32"]:
            raise AssertionError(f"{name} holds no TF32 tensor-core product in its SASS")
    return out


def _check_l2_ptxas(kernels: list, warnings: list) -> None:
    """Raises where an L2_KERNELS instantiation at L2_CHECKED_DP spills or
    draws a ptxas performance warning (``kernels``, ``warnings``:
    _ptxas_kernels and _ptxas_warnings of one build log)."""
    checked = tuple(f"{k}ILi{dp}E" for k in L2_KERNELS for dp in L2_CHECKED_DP)
    for func, regs, stores, loads in kernels:
        if any(c in func for c in checked):
            print(f"  [ptxas] {func}: {regs} registers, {stores}/{loads} bytes spilled")
            if stores or loads:
                raise AssertionError(f"{func} spills ({stores} bytes stored, {loads} loaded)")
    for func, line in warnings:
        if any(c in func for c in checked):
            raise AssertionError(f"{func}: {line}")


# The kernels check_kernels also holds bit-equal across two calls, with the
# part of their CUDA symbols that the profiler's device time counts.
REPEATED = {"ln_mlp_fwd": "ln_mlp", "proj_ln_mlp_fwd": "ln_mlp", "ln_qkv_fwd": "ln_qkv"}
PRODUCTS_ONLY = ("torch.matmul of the kernel's products in bf16 at the shape: a yardstick, not "
                 "the same function")


def check_kernels(only: tuple = ()) -> dict:
    """Kernel vs plain version at the serving shapes (timed), the ragged shape
    and one long sequence; the flash forward also with out_bnhd, writing O
    in the (B, N, H*D) layout at the serving shape; the two LN->MLP forms
    and LN->qkv also bit-equal across two calls, with their device time
    (LN->qkv beside torch.matmul of its product).  ``only``: the names to
    check (default every one).  Returns {name: record} for the JSON line."""
    import torch
    import torch.nn.functional as F

    from vitgan_tpu_torch.ops import attention as A
    from vitgan_tpu_torch.ops import fused_block as FB
    from vitgan_tpu_torch.ops import fused_mlp as FM

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for label, shape in (("serving", (64, 1024, 384, 6, 1536)),
                         ("ragged", (4, 257, 192, 3, 768))):
        c = _case(*shape, gen)
        b, n, e, heads, dh, hidden = c["dims"]
        m, hd = b * n, heads * dh
        print(f"[kernels] {label}: B {b} N {n} E {e} heads {heads} Dh {dh} hidden {hidden}")
        x2 = c["x"].reshape(m, e)
        calls = {
            "flash_attn_fwd": (
                lambda: A.flash_forward(c["q"], c["k"], c["v"], float(dh))[0],
                lambda: A.attention_reference(c["q"], c["k"], c["v"], "dot", float(dh)),
                lambda: F.scaled_dot_product_attention(c["q"], c["k"], c["v"]),
                _bound(4.0 * b * heads * n * n * dh, 4 * m * hd * 2 + b * heads * n * 4), None),
            "ln_mlp_fwd": (
                lambda: FM.ln_mlp_forward(x2, c["ln_s"], c["ln_b"], c["w1"], c["b1"], c["w2"],
                                          c["b2"], residual=False),
                lambda: FM._reference(x2, c["ln_s"], c["ln_b"], c["w1"], c["b1"], c["w2"],
                                      c["b2"], "gelu", 1e-5, False),
                None,
                _bound(4.0 * m * e * hidden,
                       2 * m * e * 2 + 2 * e * hidden * 2 + (3 * e + hidden) * 4), None),
            "ln_qkv_fwd": (
                lambda: FB.ln_qkv_forward(c["x"], c["ln_s"], c["ln_b"], c["qkv_w"], c["qkv_b"]),
                lambda: FB._ln_qkv_reference(c["x"], c["ln_s"], c["ln_b"], c["qkv_w"],
                                             c["qkv_b"].reshape(-1)),
                None,
                _bound(2.0 * m * e * 3 * hd,
                       m * e * 2 + 3 * m * hd * 2 + e * 3 * hd * 2 + (2 * e + 3 * hd) * 4),
                None),
            "proj_ln_mlp_fwd": (
                lambda: FM.ln_mlp_forward(c["x"], c["ln_s"], c["ln_b"], c["w1"], c["b1"],
                                          c["w2"], c["b2"], attn=c["attn"], wout=c["wout"],
                                          bout=c["bout"]),
                lambda: FB._proj_ln_mlp_reference(c["x"], c["attn"], c["wout"], c["bout"],
                                                  c["ln_s"], c["ln_b"], c["w1"], c["b1"],
                                                  c["w2"], c["b2"]),
                None,
                _bound(2.0 * m * hd * e + 4.0 * m * e * hidden,
                       2 * m * e * 2 + m * hd * 2 + hd * e * 2 + 2 * e * hidden * 2
                       + (4 * e + hidden) * 4),
                c["x"]),
        }
        calls = {k_: v_ for k_, v_ in calls.items() if not only or k_ in only}
        for name, (kern, plain, library, (bound_ms, bound_by), residual) in calls.items():
            err = _err(kern(), plain(), f"{name} {label}", residual)
            repeat = _repeat(kern, f"{name} {label}") if name in REPEATED else None
            if label == "ragged":
                out[name]["ragged_max_abs_err"] = err
                if repeat is not None:
                    out[name]["ragged_repeat_max_abs_diff"] = repeat
                continue
            if name == "flash_attn_fwd":  # the LSE the backward will read
                s = torch.einsum("bhnd,bhmd->bhnm", c["q"].float(), c["k"].float()) / math.sqrt(dh)
                lse_err = (A.flash_forward(c["q"], c["k"], c["v"], float(dh))[1]
                           - torch.logsumexp(s, -1)).abs().max().item()
                del s
                print(f"  flash_attn_fwd lse: max_abs_err {lse_err:.6g} (tolerance 1e-2)")
                if not lse_err <= 1e-2:
                    raise AssertionError("flash LSE disagrees with logsumexp")
                # out_bnhd: O written as (B, N, H*D), the megablock's layout
                bnhd = torch.empty((b, n, hd), dtype=torch.bfloat16, device="cuda")
                A.flash_forward(c["q"], c["k"], c["v"], float(dh), out=bnhd)
                bnhd_err = _err(bnhd, plain().permute(0, 2, 1, 3).reshape(b, n, hd),
                                f"{name} {label} out_bnhd")
                del bnhd
            rec = {"max_abs_err": err, "ms": _time_ms(kern, 20), "plain_ms": _time_ms(plain, 5),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": _time_ms(library, 20) if library else None}
            if name == "flash_attn_fwd":
                rec["out_bnhd_max_abs_err"] = bnhd_err
                _with_device_ms(rec, kern, 20, name)
            if name in REPEATED:
                rec["device_ms"] = _device_ms(kern, 20, (REPEATED[name],))[0]
                rec["repeat_max_abs_diff"] = repeat
            if name == "ln_qkv_fwd":
                w_qkv = FB._qkv_weight(c["qkv_w"], torch.bfloat16)
                rec["products_only_ms"] = _time_ms(lambda: x2 @ w_qkv, 20)
                rec["products_only"] = PRODUCTS_ONLY
                del w_qkv
            print(f"  {name}: {rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f} ms, "
                  f"library {rec['library_ms']}, bound {bound_ms:.4f} ms by {bound_by})")
            out[name] = rec
        del c, x2, calls
        torch.cuda.empty_cache()

    if only and "flash_attn_fwd" not in only:
        return out
    # One long sequence: where the TPU kernel switches to streaming K/V from
    # HBM (attention.py:179); here the same kernel streams at every length.
    q, k, v = (torch.randn((1, 1, 16385, 64), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    print("[kernels] long: B*H 1 N 16385 Dh 64")
    out["flash_attn_fwd"]["long_seq_max_abs_err"] = _err(
        A.flash_forward(q, k, v, 64.0)[0], A.attention_reference(q, k, v, "dot", 64.0),
        "flash_attn_fwd long")
    out["flash_attn_fwd"]["long_seq_ms"] = _time_ms(lambda: A.flash_forward(q, k, v, 64.0), 5)
    n = 16385
    bound_ms, bound_by = _bound(4.0 * n * n * 64, 4 * n * 64 * 2 + n * 4)
    out["flash_attn_fwd"].update({
        "long_seq_bound_ms": bound_ms, "long_seq_bound_by": bound_by,
        "long_seq_plain_ms": _time_ms(lambda: A.attention_reference(q, k, v, "dot", 64.0), 2),
        "long_seq_library_ms": _time_ms(lambda: F.scaled_dot_product_attention(q, k, v), 5)})
    rec = out["flash_attn_fwd"]
    print(f"  flash_attn_fwd long: {rec['long_seq_ms']:.4f} ms (plain "
          f"{rec['long_seq_plain_ms']:.4f} ms, SDPA {rec['long_seq_library_ms']:.4f} ms, bound "
          f"{bound_ms:.4f} ms by {bound_by})")
    return out


def _post(url: str, payload: dict):
    req = urllib.request.Request(url + "/sample", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        body = r.read()
        status, ctype = r.status, r.headers.get("Content-Type")
    return status, ctype, body, (time.perf_counter() - t0) * 1e3


def _png_shape(body: bytes):
    import struct
    import zlib

    if body[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    w, h = struct.unpack(">II", body[16:24])
    pos, idat = 8, b""
    while pos < len(body):
        (length,), tag = struct.unpack(">I", body[pos:pos + 4]), body[pos + 4:pos + 8]
        if tag == b"IDAT":
            idat += body[pos + 8:pos + 8 + length]
        pos += 12 + length
    raw = zlib.decompress(idat)
    if len(raw) != h * (1 + 3 * w):
        raise AssertionError("PNG payload does not match its header")
    return h, w


def serve_main_path(run_dir: str) -> tuple:
    """Serve highres128 at batch 64 over HTTP through the default route."""
    import numpy as np
    import torch

    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.models import build_gan, count_params
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.serve import serve
    from vitgan_tpu_torch.utils.run_dirs import save_run

    cfg = C.highres_config(128)
    m = cfg.v2
    t0 = time.perf_counter()
    g = build_gan(cfg).generator_init(torch.Generator().manual_seed(SEED), device="cpu")
    print(f"[serve] highres128: image {m.image_size} patch {m.patch_size} tokens "
          f"{(m.image_size // m.patch_size) ** 2} embed {m.embed_dim} heads {m.num_heads} "
          f"depth {m.depth} latent {m.latent_dim}; {count_params(g)} generator parameters")
    save_run(run_dir, cfg, g, meta={"step": 0, "seed": SEED})
    del g
    httpd = serve(run_dir, host="127.0.0.1", port=0, batch=64)
    print(f"[serve] run dir written, restored and warmed in {time.perf_counter() - t0:.1f} s")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    service = httpd.service
    try:
        build.reset_launches()
        calls0 = service._device_calls
        # --- the main path ---
        status, ctype, png, ms = _post(url, {"n": 64, "seed": 1, "format": "png"})
        h, w = _png_shape(png)
        if status != 200 or ctype != "image/png" or (h, w) != (8 * 130 + 2, 8 * 130 + 2):
            raise AssertionError(f"png request: {status} {ctype} {h}x{w}")
        print(f"[serve] POST png n=64 seed=1: {len(png)} bytes, {h}x{w}, {ms:.1f} ms")
        status, ctype, a, ms = _post(url, {"n": 8, "seed": 2, "format": "npy"})
        arr = np.load(io.BytesIO(a))
        if status != 200 or arr.shape != (8, 128, 128, 3) or arr.dtype != np.float32:
            raise AssertionError(f"npy request: {status} {arr.shape} {arr.dtype}")
        if not (np.isfinite(arr).all() and arr.min() >= -1.0 and arr.max() <= 1.0
                and arr.std() > 1e-3):
            raise AssertionError("npy samples are not finite, distinct values in [-1, 1]")
        print(f"[serve] POST npy n=8 seed=2: {arr.shape}, std {arr.std():.4f}, {ms:.1f} ms")
        _, _, b, ms = _post(url, {"n": 8, "seed": 2, "format": "npy"})
        if a != b:
            raise AssertionError("seeded repeat is not byte-equal")
        print(f"[serve] seeded repeat byte-equal, {ms:.1f} ms")
        before = service._device_calls
        results = []

        def unseeded():
            results.append(_post(url, {"n": 16, "format": "npy"}))

        threads = [threading.Thread(target=unseeded) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if len(results) != 4 or any(r[0] != 200 for r in results):
            raise AssertionError("coalesced unseeded requests failed")
        coalesced = service._device_calls - before
        if coalesced != 1:
            raise AssertionError(f"4 concurrent n=16 requests took {coalesced} device calls")
        print(f"[serve] 4 concurrent unseeded n=16 requests: {coalesced} device call, "
              f"{max(r[3] for r in results):.1f} ms slowest")
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            info = json.loads(r.read())
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
        launches = dict(build.LAUNCHES)
        # --- end of the main path ---
        calls = service._device_calls - calls0
        if not info["device"].startswith("cuda") or info["batch"] != 64:
            raise AssertionError(f"/healthz: {info}")
        if f"vitgan_device_calls {service._device_calls}" not in metrics:
            raise AssertionError("/metrics does not report the device calls")
        print(f"[serve] /healthz {info}")
        print(f"[serve] launches over {calls} device calls: {launches}")
        _check_launches(launches, {"ln_qkv_fwd": 1, "flash_attn_fwd": 1, "proj_ln_mlp_fwd": 1,
                                   **LN_MLP_STAGES["proj_ln_mlp_fwd"]}, m.depth * calls)
        return httpd, launches, arr
    except BaseException:
        httpd.shutdown()
        httpd.server_close()
        raise


def _check_launches(launches: dict, route: dict, blocks: int) -> None:
    """Each kernel of the route launched its count a block (``route``) times
    ``blocks``, no other kernel."""
    for name, n in launches.items():
        want = route.get(name, 0) * blocks
        if n != want:
            raise AssertionError(f"{name}: {n} launches, expected {want}")


def serve_megablock_off(run_dir: str, off_dir: str, reference) -> dict:
    """Serve the same weights over HTTP with runtime.megablock=off (the run
    directory's config says so): every block takes the flash attention and
    LN->MLP kernels.  The seeded npy request must match the megablock
    route's (``reference``) within the route tolerance."""
    import numpy as np

    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.serve import serve
    from vitgan_tpu_torch.utils.run_dirs import GENERATOR_FILE

    cfg = C.replace(C.load_config(os.path.join(run_dir, "config.json")),
                    **{"runtime.megablock": "off"})
    os.makedirs(off_dir, exist_ok=True)
    C.save_config(cfg, os.path.join(off_dir, "config.json"))
    shutil.copy(os.path.join(run_dir, GENERATOR_FILE), off_dir)
    t0 = time.perf_counter()
    httpd = serve(off_dir, host="127.0.0.1", port=0, batch=64)
    print(f"[serve off] restored and warmed in {time.perf_counter() - t0:.1f} s")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    service = httpd.service
    try:
        build.reset_launches()
        calls0 = service._device_calls
        # --- the megablock=off path ---
        status, _, body, ms = _post(url, {"n": 8, "seed": 2, "format": "npy"})
        launches = dict(build.LAUNCHES)
        # --- end of the megablock=off path ---
        calls = service._device_calls - calls0
    finally:
        httpd.shutdown()
        httpd.server_close()
    arr = np.load(io.BytesIO(body))
    if status != 200 or arr.shape != reference.shape or not np.isfinite(arr).all():
        raise AssertionError(f"megablock=off npy request: {status} {arr.shape}")
    d = np.abs(arr - reference)
    print(f"[serve off] POST npy n=8 seed=2: {ms:.1f} ms; against the megablock route: "
          f"max |d| {d.max():.6g}, mean |d| {d.mean():.6g} (tolerance {IMAGE_MAX_TOL}, "
          f"{IMAGE_MEAN_TOL})")
    if not (d.max() <= IMAGE_MAX_TOL and d.mean() <= IMAGE_MEAN_TOL):
        raise AssertionError("megablock=off route disagrees with the megablock route")
    print(f"[serve off] launches over {calls} device call: {launches}")
    _check_launches(launches, {"flash_attn_fwd": 1, "ln_mlp_fwd": 1, **LN_MLP_STAGES["ln_mlp_fwd"]},
                    cfg.v2.depth * calls)
    return launches


def compare_routes(httpd) -> dict:
    """The same latents through the megablock, megablock=off and plain routes."""
    import torch

    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.ops.policy import get_policy, set_policy
    from vitgan_tpu_torch.train.sample import latent_rng

    service = httpd.service
    g = service.generator
    z = service.gan.sample_latent(latent_rng(7, 0), 64).cuda()
    saved = get_policy()
    imgs, launches, ms = {}, {}, {}
    routes = (("megablock", dict(mode="auto", megablock="auto"), torch.bfloat16),
              ("megablock_off", dict(mode="auto", megablock="off"), torch.bfloat16),
              ("plain", dict(mode="never"), torch.bfloat16),
              ("plain_f32", dict(mode="never"), torch.float32))
    try:
        with torch.inference_mode():
            for name, policy, dtype in routes:
                set_policy(**policy)
                zz = z.to(dtype)
                build.reset_launches()
                imgs[name] = g(zz).float()
                torch.cuda.synchronize()
                launches[name] = dict(build.LAUNCHES)
                ms[name] = _time_ms(lambda: g(zz), 3)
                if not torch.isfinite(imgs[name]).all() or imgs[name].shape != (64, 128, 128, 3):
                    raise AssertionError(f"{name}: bad generator output")
    finally:
        set_policy(**{k: saved[k] for k in ("mode", "megablock")})
    print(f"[routes] ms per batch-64 generator call: {ms}")
    print(f"[routes] launches: {launches}")
    depth = service.cfg.v2.depth
    off = launches["megablock_off"]
    if off["flash_attn_fwd"] != depth or off["ln_mlp_fwd"] != depth:
        raise AssertionError("megablock=off route did not launch flash and LN->MLP per block")
    if any(launches["plain"].values()) or any(launches["plain_f32"].values()):
        raise AssertionError("the plain route launched a kernel")
    errs = {}
    for a, b in (("megablock", "plain"), ("megablock_off", "plain"),
                 ("megablock", "plain_f32"), ("megablock_off", "plain_f32"),
                 ("plain", "plain_f32")):
        d = (imgs[a] - imgs[b]).abs()
        errs[f"{a}_vs_{b}"] = (d.max().item(), d.mean().item())
        print(f"[routes] {a} vs {b}: max |d| {errs[f'{a}_vs_{b}'][0]:.6g}, mean |d| "
              f"{errs[f'{a}_vs_{b}'][1]:.6g} (tolerance {IMAGE_MAX_TOL}, {IMAGE_MEAN_TOL})")
        if not (d.max().item() <= IMAGE_MAX_TOL and d.mean().item() <= IMAGE_MEAN_TOL):
            raise AssertionError(f"{a} and {b} routes disagree")
    return {"call_ms": ms, "launches_megablock_off": off, "errors": errs}


BWD_SHAPES = (("G", (32, 6, 1024, 64)), ("D", (64, 6, 1025, 64)), ("ragged", (2, 3, 257, 64)),
              ("long", (1, 1, 16385, 64)),
              # highres256p4's G (4,096 tokens) and D on [real; fake] (4,097: the
              # last of 33 key blocks holds one key); the single pass runs both
              ("p4G", (8, 6, 4096, 64)), ("p4D", (16, 6, 4097, 64)))
# The shape at which each backward kernel runs on the train step's main path.
BWD_MAIN_SHAPE = {"flash_attn_bwd_fused": "G", "flash_attn_bwd_dq": "D",
                  "flash_attn_bwd_dkv": "D"}


def check_bwd_kernels() -> dict:
    """The three backward kernels against their plain versions on the same
    q, k, v, o, LSE and dO at BWD_SHAPES, timed beside their bounds, their
    plain versions and SDPA's backward.  Returns {name: record}."""
    import torch
    import torch.nn.functional as F

    from vitgan_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    # products per kernel (2*N*N*Dh flops each) and the tensors it writes
    kernels = {"flash_attn_bwd_fused": (A.flash_backward_fused, A.flash_bwd_fused_reference, 5, 3),
               "flash_attn_bwd_dq": (A.flash_backward_dq, A.flash_bwd_dq_reference, 3, 1),
               "flash_attn_bwd_dkv": (A.flash_backward_dkv, A.flash_bwd_dkv_reference, 4, 2)}
    out = {name: {} for name in kernels}
    for label, shape in BWD_SHAPES:
        b, h, n, dh = shape
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        o, lse = A.flash_forward(q, k, v, float(dh))
        print(f"[bwd kernels] {label}: B {b} H {h} N {n} Dh {dh}")
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qg, kg, vg)
        library = lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), do,  # noqa: E731
                                              retain_graph=True)
        library_ms = _time_ms(library, 5 if n > 8192 else 20)
        elem = b * h * n * dh * 2
        for name, (kern, plain, products, writes) in kernels.items():
            args = (q, k, v, o, lse, do, float(dh))
            got, want = kern(*args), plain(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(_err(g_, w_, f"{name} {label} out{i}", own_scale=True)
                      for i, (g_, w_) in enumerate(zip(got, want)))
            del got, want
            # every backward kernel's outputs are bit-equal across two calls
            repeat = _repeat(lambda: kern(*args), f"{name} {label}")
            bound_ms, bound_by = _bound(2.0 * products * b * h * n * n * dh,
                                        (5 + writes) * elem + b * h * n * 4)
            rec = {"max_abs_err": err, "ms": _time_ms(lambda: kern(*args), 5 if n > 8192 else 20),
                   "plain_ms": _time_ms(lambda: plain(*args), 2), "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": library_ms, "repeat_max_abs_diff": repeat}
            main = label == BWD_MAIN_SHAPE[name]
            if main:  # the kernel's own device time apart from the wrapper's delta
                _with_device_ms(rec, lambda: kern(*args), 5, name)
            torch.cuda.empty_cache()
            print(f"  {name} {label}: {rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f} ms, SDPA "
                  f"backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by})"
                  + (f"; device: the kernel's {rec['device_ms']} ms, the wrapper's other "
                     f"{rec['other_device_ms']} ms" if main else ""))
            if main:
                out[name].update(rec)
            else:
                out[name][f"{label}_max_abs_err"] = err
                out[name][f"{label}_ms"] = rec["ms"]
                out[name][f"{label}_repeat_max_abs_diff"] = repeat
                for key in ("plain_ms", "bound_ms", "bound_by", "library_ms"):
                    out[name][f"{label}_{key}"] = rec[key]
        del q, k, v, do, o, lse, qg, kg, vg, sdpa_out, library
        torch.cuda.empty_cache()
    return out


MB_SHAPES = (("G", (32, 1024, 384, 6, 1536)), ("D", (64, 1025, 384, 6, 1536)),
             ("ragged", (2, 257, 192, 3, 768)), ("deit64", (128, 257, 192, 3, 768)))
# The stage kernels of megablock_bwd_mlp.cu, each launched once by a call of
# the backward's MLP half (counted as "megablock_bwd_mlp"), and the part of
# their CUDA symbols (and of the parent's single kernel, which
# scripts/kernel_ab.py measures).
MB_MLP_STAGES = ("megablock_bwd_mlp_dz1", "megablock_bwd_mlp_dx1", "megablock_bwd_mlp_dao")
MB_MLP_SYMBOL = "megablock_bwd_mlp"
MB_RATE = 0.1
# The saved-residual backward against autograd of the plain block: dx and each
# of the 12 parameter gradients within MB_GRAD_RTOL * its own max|plain|.
# The kernels round dmlp, dz1, da, dao, dqkv and the LN and GELU operands of
# the weight gradients to bf16 before each product, where the plain block
# keeps f32; the weight gradients sum up to 65,600 such rows in f32.
MB_GRAD_RTOL = 2e-2


def _mb_case(b, n, e, heads, hidden, gen):
    """One training block's bf16 inputs on the card: _case plus a cotangent,
    an int64 seed and the block's parameters as an EncoderBlock-shaped view."""
    import torch

    from vitgan_tpu_torch.ops import fused_block as FB

    c = _case(b, n, e, heads, hidden, gen)
    c["g"] = torch.randn((b, n, e), generator=gen, device="cuda").to(torch.bfloat16)
    c["seed"] = torch.randint(0, 2 ** 62, (1,), generator=gen, device="cuda")
    c["params"] = [c[k].float() for k in ("ln_s", "ln_b", "qkv_w", "qkv_b", "wout", "bout",
                                          "ln_s", "ln_b", "w1", "b1", "w2", "b2")]
    c["p"] = FB._block_view(c["params"])
    return c


def _mb_mlp_stages(args, label: str) -> dict:
    """megablock_bwd_mlp.cu stage by stage on one call's inputs: each stage
    kernel against its stage plain version on the same bf16 inputs (the
    plain dz1 and da feed the next stages), each output within KERNEL_RTOL *
    its own max|plain| (dln2 by the partials' column sums), with its device
    time by the profiler and its bound.  Returns {stage: record}."""
    from vitgan_tpu_torch.ops import fused_block as FB

    g, m1, m2, x1, z1, ao, w1, w2, wout, ln_s, ln_b, b, n, heads = args
    (m, e), hidden, hd = g.shape, z1.shape[-1], ao.shape[-1]
    masks = m1 is not None
    dz1 = FB.bwd_dz1_stage_reference(g, m2, z1, w2)
    dx1 = FB.bwd_dx1_stage_reference(dz1[1], g, m1, x1, w1, ln_s, ln_b)
    da = dx1[1]
    stages = {
        "dz1": (lambda: FB.bwd_dz1_stage(g, m2, z1, w2), dz1, ("dmlp", "dz1", "h1"),
                # reads g, [m2], z1, w2; writes [dmlp], dz1, h1
                _bound(2.0 * m * e * hidden, m * e * (2 + 4 * masks) + m * hidden * 2
                       + hidden * e * 2 + m * e * 2 * masks + 2 * m * hidden * 2)),
        "dx1": (lambda: FB.bwd_dx1_stage(dz1[1], g, m1, x1, w1, ln_s, ln_b), dx1,
                ("dx1", "da", "y2", "dln2"),
                # reads dz1, g, x1, [m1], w1; writes dx1, da, y2, part
                _bound(2.0 * m * e * hidden, m * hidden * 2 + m * e * (4 + 4 * masks)
                       + e * hidden * 2 + m * e * (4 + 2 + 2) + dx1[3].numel() * 4)),
        "dao": (lambda: FB.bwd_dao_stage(da, ao, wout, b, n, heads),
                FB.bwd_dao_stage_reference(da, ao, wout, b, n, heads), ("dao", "delta"),
                # reads da, ao, wout; writes dao, delta
                _bound(2.0 * m * e * hd, m * e * 2 + m * hd * 2 + hd * e * 2 + m * hd * 2
                       + m * heads * 4))}
    out = {}
    for stage, (call, want, names, bound) in stages.items():
        errs = []
        for name, got, ref in zip(names, call(), want):
            if name == "dln2":
                got, ref = got.sum(0), ref.sum(0)
            errs.append(_err(got, ref, f"megablock_bwd_mlp {label} stage {stage} {name}",
                             own_scale=True))
        out[stage] = {"max_abs_err": max(errs),
                      "device_ms": _device_ms(call, 10, (MB_MLP_SYMBOL,))[0],
                      "bound_ms": bound[0], "bound_by": bound[1]}
        print(f"  megablock_bwd_mlp {label} stage {stage}: device {out[stage]['device_ms']} ms "
              f"(bound {bound[0]:.4f} ms by {bound[1]})")
    return out


def check_megablock_kernels() -> dict:
    """The megablock's training kernels against their plain versions at G's,
    D's, a ragged and deit64's D-update shape: the training form of ln_mlp_fwd (masks bit-equal
    to the plain Philox's, outputs and residuals by KERNEL_RTOL, bit-equal
    across two calls), the backward's MLP half (bit-equal across two calls,
    and stage by stage on a tree that has the stages) and LN1 half and
    wgrad_gemm (each output within KERNEL_RTOL * its own max|plain|),
    sum_partials, then the whole saved-residual
    backward against autograd of the plain masked block (MB_GRAD_RTOL).
    Times each at each shape; the record at G's shape goes to the JSON line."""
    import torch

    from vitgan_tpu_torch.ops import fused_block as FB
    from vitgan_tpu_torch.ops import wgrad as WG

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    out = {k: {} for k in ("ln_qkv_fwd", "ln_mlp_train_fwd", "megablock_bwd_mlp",
                           "megablock_bwd_ln1", "wgrad_gemm", "sum_partials")}
    whole = {}
    for label, shape in MB_SHAPES:
        c = _mb_case(*shape, gen)
        b, n, e, heads, dh, hidden = c["dims"]
        m, hd = b * n, heads * dh
        print(f"[megablock kernels] {label}: B {b} N {n} E {e} heads {heads} hidden {hidden}")
        x2, attn2, g2 = c["x"].reshape(m, e), c["attn"].reshape(m, hd), c["g"].reshape(m, e)
        recs = {}

        def rec(name, kern, plain, bound, library=None, iters=10):
            ms = _time_ms(kern, iters)
            r = {"ms": ms, "plain_ms": _time_ms(plain, 2), "bound_ms": bound[0],
                 "bound_by": bound[1], "library_ms": _time_ms(library, iters) if library else None}
            print(f"  {name} {label}: {ms:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
                  f"{r['library_ms']}, bound {bound[0]:.4f} ms by {bound[1]})")
            recs[name] = r

        # -- the training forward's first launch (and the saved backward's qkv
        # recompute): the output in (3, B, H, N, Dh), rows straddling samples
        qkv_args = (c["x"], c["ln_s"], c["ln_b"], c["qkv_w"], c["qkv_b"].reshape(-1))
        err = _err(FB.ln_qkv_forward(*qkv_args), FB._ln_qkv_reference(*qkv_args),
                   f"ln_qkv_fwd {label}")
        rec("ln_qkv_fwd", lambda: FB.ln_qkv_forward(*qkv_args),
            lambda: FB._ln_qkv_reference(*qkv_args),
            _bound(2.0 * m * e * 3 * hd,
                   m * e * 2 + 3 * m * hd * 2 + e * 3 * hd * 2 + (2 * e + 3 * hd) * 4))
        recs["ln_qkv_fwd"]["max_abs_err"] = err
        recs["ln_qkv_fwd"]["repeat_max_abs_diff"] = _repeat(
            lambda: FB.ln_qkv_forward(*qkv_args), f"ln_qkv_fwd {label}")
        recs["ln_qkv_fwd"]["device_ms"] = _device_ms(lambda: FB.ln_qkv_forward(*qkv_args), 10,
                                                     ("ln_qkv",))[0]
        w_qkv = FB._qkv_weight(c["qkv_w"], torch.bfloat16)
        recs["ln_qkv_fwd"]["products_only_ms"] = _time_ms(lambda: x2 @ w_qkv, 10)
        del w_qkv

        # -- the training forward's third launch
        fwd_args = (x2, attn2, c["wout"], c["bout"], c["ln_s"], c["ln_b"], c["w1"], c["b1"],
                    c["w2"], c["b2"], c["seed"], MB_RATE)
        got = FB.ln_mlp_train_forward(*fwd_args)
        want = FB._proj_ln_mlp_train_reference(*fwd_args)
        torch.cuda.synchronize()
        for i, what in ((1, "m1"), (2, "m2")):
            if not torch.equal(got[i], want[i]):
                raise AssertionError(f"ln_mlp_train_fwd {label}: {what} is not bit-equal to the "
                                     "plain Philox's")
        keep = (got[1] > 0).float().mean().item()
        print(f"  ln_mlp_train_fwd {label}: masks bit-equal to the plain Philox's "
              f"(keep share {keep:.5f})")
        err = max(_err(got[0], want[0], f"ln_mlp_train_fwd {label} out", want[3]),
                  _err(got[3], want[3], f"ln_mlp_train_fwd {label} x1", x2),
                  _err(got[4], want[4], f"ln_mlp_train_fwd {label} z1"))
        rec("ln_mlp_train_fwd", lambda: FB.ln_mlp_train_forward(*fwd_args),
            lambda: FB._proj_ln_mlp_train_reference(*fwd_args),
            _bound(2.0 * m * hd * e + 4.0 * m * e * hidden,
                   # reads x, attn and the weights; writes out, x1, z1, m1, m2
                   m * (e + hd) * 2 + (hd * e + 2 * e * hidden) * 2 + 2 * m * e * 2
                   + m * hidden * 2 + 2 * m * e * 4))
        recs["ln_mlp_train_fwd"]["max_abs_err"] = err
        recs["ln_mlp_train_fwd"]["repeat_max_abs_diff"] = _repeat(
            lambda: FB.ln_mlp_train_forward(*fwd_args), f"ln_mlp_train_fwd {label}")
        recs["ln_mlp_train_fwd"]["device_ms"] = _device_ms(
            lambda: FB.ln_mlp_train_forward(*fwd_args), 10, (LN_MLP_SYMBOL,))[0]
        _, m1, m2, x1, z1 = got
        del got, want

        # -- the backward's MLP half
        bwd_args = (g2, m1, m2, x1, z1, attn2, c["w1"], c["w2"], c["wout"], c["ln_s"], c["ln_b"],
                    b, n, heads)
        err = 0.0
        # without dropout (dmlp is g itself), then with the forward's masks, whose
        # outputs feed the checks below
        for what, args in ((" no dropout", (g2, None, None, *bwd_args[3:])), ("", bwd_args)):
            got, want = FB.megablock_bwd_mlp(*args), FB._bwd_mlp_reference(*args)
            err = max(err, *(_err(getattr(got, k), getattr(want, k),
                                  f"megablock_bwd_mlp {label}{what} {k}", own_scale=True)
                             for k in ("dmlp", "dz1", "h1", "y2", "dx1", "da", "dao", "delta")))
            err = max(err, _err(got.part.sum(0), want.part[0],
                                f"megablock_bwd_mlp {label}{what} dln2", own_scale=True))
        rec("megablock_bwd_mlp", lambda: FB.megablock_bwd_mlp(*bwd_args),
            lambda: FB._bwd_mlp_reference(*bwd_args),
            _bound(4.0 * m * e * hidden + 2.0 * m * e * hd,
                   2 * m * e * 2 + m * hidden * 2 + m * hd * 2 + 2 * m * e * 4
                   + (2 * e * hidden + hd * e) * 2 + m * e * (2 + 2 + 4 + 2) + 2 * m * hidden * 2
                   + m * hd * 2 + b * heads * n * 4))
        recs["megablock_bwd_mlp"]["max_abs_err"] = err
        recs["megablock_bwd_mlp"]["repeat_max_abs_diff"] = _repeat(
            lambda: FB.megablock_bwd_mlp(*bwd_args), f"megablock_bwd_mlp {label}")
        recs["megablock_bwd_mlp"]["device_ms"] = _device_ms(
            lambda: FB.megablock_bwd_mlp(*bwd_args), 10, (MB_MLP_SYMBOL,))[0]
        if hasattr(FB, "bwd_dz1_stage"):  # a parent measured by kernel_ab.py has one kernel
            recs["megablock_bwd_mlp"]["stages"] = _mb_mlp_stages(bwd_args, label)
        mlp = got
        del want

        # -- the backward's LN1 half, on a cotangent of qkv's size: dx, its
        # LN1^T(dy1) term (dx - dx1) by its own scale, y1, the dln1 partials
        # row for row (a row a 64-row tile; compared by their sums where the
        # plain version gives one row, as a parent's does) and sum_partials
        # of them against the plain sum
        dqkv = torch.randn((m, 3 * hd), generator=gen, device="cuda").to(torch.bfloat16)
        ln1_args = (dqkv, c["qkv_w"], x2, mlp.dx1, c["ln_s"], c["ln_b"])
        got = FB.megablock_bwd_ln1(*ln1_args)
        want = FB._bwd_ln1_reference(*ln1_args)
        rows = got[2].shape[0] == want[2].shape[0]
        err = max(_err(got[0], want[0], f"megablock_bwd_ln1 {label} dx", own_scale=True),
                  _err(got[0].float() - mlp.dx1, want[0].float() - mlp.dx1,
                       f"megablock_bwd_ln1 {label} LN1^T(dy1)", own_scale=True),
                  _err(got[1], want[1], f"megablock_bwd_ln1 {label} y1", own_scale=True),
                  _err(got[2] if rows else got[2].sum(0), want[2] if rows else want[2][0],
                       f"megablock_bwd_ln1 {label} dln1 partials"
                       + (" (row for row)" if rows else " (summed)"), own_scale=True),
                  _err(WG.sum_partials(got[2]), want[2].sum(0),
                       f"megablock_bwd_ln1 {label} dln1 summed", own_scale=True))
        rec("megablock_bwd_ln1", lambda: FB.megablock_bwd_ln1(*ln1_args),
            lambda: FB._bwd_ln1_reference(*ln1_args),
            _bound(2.0 * m * 3 * hd * e, m * 3 * hd * 2 + m * e * 2 + m * e * 4 + 3 * hd * e * 2
                   + 2 * m * e * 2))
        recs["megablock_bwd_ln1"]["max_abs_err"] = err
        recs["megablock_bwd_ln1"]["repeat_max_abs_diff"] = _repeat(
            lambda: FB.megablock_bwd_ln1(*ln1_args), f"megablock_bwd_ln1 {label}")
        recs["megablock_bwd_ln1"]["device_ms"] = _device_ms(
            lambda: FB.megablock_bwd_ln1(*ln1_args), 10, ("megablock_bwd_ln1",))[0]
        w_t = FB._qkv_weight(c["qkv_w"], torch.bfloat16).t().contiguous()
        recs["megablock_bwd_ln1"]["products_only_ms"] = _time_ms(lambda: dqkv @ w_t, 10)
        y1, ln1_part = got[1], got[2]
        del got, want, w_t

        # -- the four weight-gradient products of one block backward
        pairs = {"dw2": (mlp.h1, mlp.dmlp), "dw1": (mlp.y2, mlp.dz1), "dwout": (attn2, mlp.da),
                 "dwqkv": (y1, dqkv)}
        errs, tot = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0.0,
                         "bytes": 0.0}
        for key, args in pairs.items():
            a_, b_ = args[0], args[1]
            got, want = WG.wgrad_gemm(*args), WG.wgrad_reference(*args)
            again = WG.wgrad_gemm(*args)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
                raise AssertionError(f"wgrad_gemm {label} {key}: two calls are not bit-equal")
            del again
            errs += [_err(got[0], want[0], f"wgrad_gemm {label} {key}", own_scale=True),
                     _err(got[1], want[1], f"wgrad_gemm {label} d{key[1:].replace('w', 'b')}",
                          own_scale=True)]
            aT = a_.t()
            tot["ms"] += _time_ms(lambda: WG.wgrad_gemm(*args), 10)
            tot["plain_ms"] += _time_ms(lambda: WG.wgrad_reference(*args), 2)
            tot["library_ms"] += _time_ms(lambda: torch.matmul(aT, b_), 10)
            tot["flops"] += 2.0 * m * a_.shape[1] * b_.shape[1]
            tot["bytes"] += (m * (a_.shape[1] + b_.shape[1]) * 2 + a_.shape[1] * b_.shape[1] * 4
                             + b_.shape[1] * 4)
            del got, want
        bound = _bound(tot["flops"] / 4, tot["bytes"] / 4)
        recs["wgrad_gemm"] = {"max_abs_err": max(errs), "ms": tot["ms"] / 4,
                              "plain_ms": tot["plain_ms"] / 4, "bound_ms": bound[0],
                              "bound_by": bound[1], "library_ms": tot["library_ms"] / 4,
                              "per": "launch, mean of the four products of one block backward"}
        print(f"  wgrad_gemm {label}: dW and db bit-equal across two calls")
        print(f"  wgrad_gemm {label}: mean of 4 products {tot['ms'] / 4:.4f} ms (plain "
              f"{tot['plain_ms'] / 4:.4f}, torch.matmul {tot['library_ms'] / 4:.4f}, bound "
              f"{bound[0]:.4f} ms by {bound[1]})")

        # -- the second pass of the LN partials: bit-equal to its order model
        # (a tree without one, as a parent measured by scripts/kernel_ab.py,
        # is held to part.sum(0) alone) and across two calls
        err = _err(WG.sum_partials(ln1_part), ln1_part.sum(0), f"sum_partials {label}",
                   own_scale=True)
        order_model = getattr(WG, "sum_partials_reference", None)
        if order_model is not None:
            if not torch.equal(WG.sum_partials(ln1_part), order_model(ln1_part)):
                raise AssertionError(f"sum_partials {label}: not bit-equal to "
                                     "sum_partials_reference")
            print(f"  sum_partials {label}: bit-equal to sum_partials_reference")
        repeat = _repeat(lambda: WG.sum_partials(ln1_part), f"sum_partials {label}")
        # its plain version is one PyTorch call, so it is the library time too
        rec("sum_partials", lambda: WG.sum_partials(ln1_part), lambda: ln1_part.sum(0),
            _bound(0.0, ln1_part.numel() * 4 + ln1_part.shape[1] * 4),
            library=lambda: ln1_part.sum(0))
        recs["sum_partials"]["max_abs_err"] = err
        recs["sum_partials"]["repeat_max_abs_diff"] = repeat
        # below 0.1 ms a wrapper time is host-paced: the profiler's device time
        # of the kernel and of the library call (every device op of the call)
        dev = {"device_ms": _device_ms(lambda: WG.sum_partials(ln1_part), 20,
                                       ("sum_partials",))[0],
               "library_device_ms": _device_ms(lambda: ln1_part.sum(0), 20, ("",))[0]}
        recs["sum_partials"].update(dev)
        print(f"  sum_partials {label}: device {dev['device_ms']} ms, part.sum(0) device "
              f"{dev['library_device_ms']} ms")
        del mlp, dqkv, y1, ln1_part, m1, m2, x1, z1

        # -- the whole block: kernel forward with residuals and the saved
        # backward against autograd of the plain masked block in f32
        fwd, res = FB.fused_encoder_block(c["x"], c["p"], num_heads=heads, rate=MB_RATE,
                                          seed=c["seed"], want_residuals=True)
        dx, dparams = FB.fused_encoder_block_bwd(c["params"], c["g"], res, num_heads=heads)
        leaves = [c["x"].float().requires_grad_(), *(t.clone().requires_grad_()
                                                     for t in c["params"])]
        ref = FB._block_reference_masked(leaves[0], FB._block_view(leaves[1:]), res.m1, res.m2,
                                         heads)
        _err(fwd, ref, f"megablock block {label} forward", res.x1)
        want = torch.autograd.grad(ref, leaves, c["g"].float())
        worst = 0.0
        for name, gk, gp in zip(("x",) + FB.BLOCK_PARAMS, (dx, *dparams), want):
            torch.cuda.synchronize()
            e_ = (gk.float() - gp).abs().max().item() / gp.abs().max().item()
            worst = max(worst, e_)
            if not e_ <= MB_GRAD_RTOL:
                raise AssertionError(f"megablock backward {label}: d{name} is {e_:.4g} of its "
                                     f"max|plain| apart (limit {MB_GRAD_RTOL})")
        bwd_ms = _time_ms(lambda: FB.fused_encoder_block_bwd(c["params"], c["g"], res,
                                                             num_heads=heads), 5)
        fwd_ms = _time_ms(lambda: FB.fused_encoder_block(
            c["x"], c["p"], num_heads=heads, rate=MB_RATE, seed=c["seed"], want_residuals=True), 5)
        whole[label] = {"worst_grad_rel": worst, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms}
        print(f"[megablock block] {label}: dx and 12 parameter gradients within {worst:.4g} of "
              f"their max|plain| (limit {MB_GRAD_RTOL}); forward {fwd_ms:.3f} ms, saved "
              f"backward {bwd_ms:.3f} ms")
        del fwd, res, dx, dparams, leaves, ref, want, c
        torch.cuda.empty_cache()
        for name, r in recs.items():
            if label == "G":
                out[name].update(r)
            else:
                out[name][f"{label}_max_abs_err"] = r["max_abs_err"]
                out[name][f"{label}_ms"] = r["ms"]
                for key in ("repeat_max_abs_diff", "device_ms", "products_only_ms"):
                    if key in r:
                        out[name][f"{label}_{key}"] = r[key]
    for name in ("ln_qkv_fwd", "megablock_bwd_ln1"):
        out[name]["products_only"] = PRODUCTS_ONLY
    return out, whole


# The LN->MLP stage shapes (rows, E, hidden, H*Dh): the serving call's, G's
# and D's training blocks at highres128, and a ragged deit64-width one.  The
# main shape of each form (its kernel-table row): the serving shape for the
# plain LN->MLP and the serving form, G's for the training form.
LN_MLP_SHAPES = (("serving", (64 * 1024, 384, 1536, 384)), ("G", (32 * 1024, 384, 1536, 384)),
                 ("D", (64 * 1025, 384, 1536, 384)), ("ragged", (2 * 257, 192, 768, 192)))
LN_MLP_MAIN = {"ln_mlp_fwd": "serving", "proj_ln_mlp_fwd": "serving", "ln_mlp_train_fwd": "G"}
# The stage kernels that one call of each LN->MLP form launches, held against
# the counts of every path that runs the form.
LN_MLP_STAGES = {"ln_mlp_fwd": {"ln_mlp_fc1": 1, "ln_mlp_linear": 1},
                 "proj_ln_mlp_fwd": {"ln_mlp_fc1": 1, "ln_mlp_linear": 2},
                 "ln_mlp_train_fwd": {"ln_mlp_fc1": 1, "ln_mlp_linear": 2}}


def _ln_mlp_launches(launches: dict, form: str) -> dict:
    """The stage kernels' launches on a path whose only LN->MLP form is
    ``form``: {"launches": their sum, "calls": the form's calls,
    "launches_per_call", "stage_launches": {stage: n}}."""
    others = [f for f in LN_MLP_STAGES if f != form and launches[f]]
    stages = {k: launches[k] for k in LN_MLP_STAGES[form]}
    if others or not launches[form] or not all(stages.values()):
        raise AssertionError(f"{form}: the path ran {launches[form]} calls, other forms "
                             f"{others}, stage launches {stages}")
    n = sum(stages.values())
    return {"launches": n, "calls": launches[form], "launches_per_call": n / launches[form],
            "stage_launches": stages}


def _mb_mlp_launches(launches: dict) -> dict:
    """The backward MLP half's stage launches on a path: {"launches": their
    sum, "calls", "launches_per_call", "stage_launches": {stage: n}}; each
    stage launched once a call."""
    stages = {k: launches[k] for k in MB_MLP_STAGES}
    calls = launches["megablock_bwd_mlp"]
    if not calls or any(c != calls for c in stages.values()):
        raise AssertionError(f"megablock_bwd_mlp: {calls} calls, stage launches {stages}")
    n = sum(stages.values())
    return {"launches": n, "calls": calls, "launches_per_call": n / calls,
            "stage_launches": stages}


def check_ln_mlp_stages() -> dict:
    """ln_mlp_fwd.cu stage by stage at LN_MLP_SHAPES: the linear stage as the
    out-projection (dropout stream 0, residual x) and as fc2 (stream 1,
    residual x1), and LN -> fc1 -> GELU with z1, each against its stage plain
    version (fused_mlp) on the same bf16 inputs, masks bit-equal to the plain
    Philox's.  (The three forms, whole, are held to their plain versions and
    across two calls by check_kernels and check_megablock_kernels.)  At each
    form's main shape, the time torch.matmul takes for the same products
    ("products only": a yardstick beside the bound, not the same function).
    Returns {form: record}."""
    import torch

    from vitgan_tpu_torch.ops import fused_block as FB
    from vitgan_tpu_torch.ops import fused_mlp as FM

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    stages_by_shape = {}
    out = {name: {"stages": stages_by_shape} for name in LN_MLP_STAGES}
    for label, (m, e, hidden, hd) in LN_MLP_SHAPES:
        print(f"[ln_mlp stages] {label}: rows {m} E {e} hidden {hidden} H*Dh {hd}")
        c = _case(1, m, e, e // 64, hidden, gen)  # H*Dh = E: heads of 64
        x, attn = c["x"].reshape(m, e), c["attn"].reshape(m, hd)
        seed = torch.randint(0, 2 ** 62, (1,), generator=gen, device="cuda")
        x1, m1 = FM.linear_stage(attn, c["wout"], c["bout"], x, seed, MB_RATE, 0)
        want_m1 = FB.dropout_mask(seed, 0, (m, e), MB_RATE)
        h, z1 = FM.ln_fc1_stage(x1, c["ln_s"], c["ln_b"], c["w1"], c["b1"], want_z1=True)
        want_h, want_z1 = FM.ln_fc1_stage_reference(x1, c["ln_s"], c["ln_b"], c["w1"], c["b1"])
        o, m2 = FM.linear_stage(want_h, c["w2"], c["b2"], x1, seed, MB_RATE, 1)
        want_m2 = FB.dropout_mask(seed, 1, (m, e), MB_RATE)
        torch.cuda.synchronize()
        if not (torch.equal(m1, want_m1) and torch.equal(m2, want_m2)):
            raise AssertionError(f"linear stage {label}: masks not bit-equal to the plain "
                                 "Philox's")
        stages_by_shape[label] = {
            "proj": _err(x1, FM.linear_stage_reference(attn, c["wout"], c["bout"], x, want_m1),
                         f"linear stage (out-projection) {label}", x),
            "fc1_h": _err(h, want_h, f"LN->fc1->GELU stage {label} h"),
            "fc1_z1": _err(z1, want_z1, f"LN->fc1->GELU stage {label} z1"),
            "fc2": _err(o, FM.linear_stage_reference(want_h, c["w2"], c["b2"], x1, want_m2),
                        f"linear stage (fc2) {label}", x1)}
        print("  stage masks bit-equal to the plain Philox's")
        del x1, m1, z1, o, m2, want_z1, want_m1, want_m2
        products = {
            "ln_mlp_fwd": lambda: (x @ c["w1"], want_h @ c["w2"]),
            "proj_ln_mlp_fwd": lambda: (attn @ c["wout"], x @ c["w1"], want_h @ c["w2"]),
            "ln_mlp_train_fwd": lambda: (attn @ c["wout"], x @ c["w1"], want_h @ c["w2"])}
        for name, main in LN_MLP_MAIN.items():
            if main == label:
                rec = out[name]
                rec["products_only_ms"] = _time_ms(products[name], 10)
                rec["products_only"] = ("torch.matmul of the form's products in bf16 at the "
                                        "main shape: a yardstick, not the same function")
                print(f"  {name}: products only (torch.matmul) {rec['products_only_ms']:.4f} ms")
        del c, x, attn, h, want_h, products
        torch.cuda.empty_cache()
    return out


# --- the wide variants (E > 384) ------------------------------------------------------

# DeiT-B's widths (Touvron et al. 2021, Table 1: embed 768, 12 heads of 64,
# hidden 3,072) at deit64's tokens and batch: G's 64 x 256 rows and D's
# 64 x 257 (a D update's [real; fake] forward is twice that).
WIDE_SHAPES = (("G", (64, 256, 768, 12, 3072)), ("D", (64, 257, 768, 12, 3072)))
# highres128's G training block, where the resident kernels run: the wide
# variants forced there against them.
FORCED_SHAPE = (32, 1024, 384, 6, 1536)
# The wide variants' launches, each under its own name: (source, the TPU
# kernel whose work it does, the form it belongs to).
WIDE_KERNELS = {
    "ln_rows": ("ln_rows.cuh", "vitgan_tpu/ops/fused_mlp.py:133", "LN->fc1 and LN->qkv"),
    "ln_mlp_fc1_wide": ("ln_mlp_fwd.cu", "vitgan_tpu/ops/fused_mlp.py:133", "LN->fc1"),
    "ln_qkv_fwd_wide": ("ln_qkv_fwd.cu", "vitgan_tpu/ops/fused_block.py:408", "LN->qkv"),
    "megablock_bwd_mask_rows": ("ln_rows.cuh", "vitgan_tpu/ops/fused_block.py:700", "MLP half"),
    "megablock_bwd_mlp_dz1_wide": ("megablock_bwd_mlp.cu", "vitgan_tpu/ops/fused_block.py:700",
                                   "MLP half"),
    "megablock_bwd_dy": ("megablock_bwd_mlp.cu", "vitgan_tpu/ops/fused_block.py:700",
                         "MLP half and LN1 half"),
    "megablock_bwd_mlp_dx1_rows": ("ln_rows.cuh", "vitgan_tpu/ops/fused_block.py:700",
                                   "MLP half"),
    "megablock_bwd_mlp_dao_wide": ("megablock_bwd_mlp.cu", "vitgan_tpu/ops/fused_block.py:700",
                                   "MLP half"),
    "megablock_bwd_ln1_rows": ("ln_rows.cuh", "vitgan_tpu/ops/fused_block.py:700", "LN1 half"),
}
# The part of each wide launch's CUDA symbol the profiler counts (the
# streamed products are the resident kernels' templates with kStream true).
WIDE_SYMBOLS = {"ln_rows": "ln_rows_kernel", "ln_mlp_fc1_wide": "ln_mlp_fc1_kernel",
                "ln_qkv_fwd_wide": "ln_qkv_fwd_kernel", "megablock_bwd_mask_rows": "mask_rows",
                "megablock_bwd_mlp_dz1_wide": "megablock_bwd_mlp_rows",
                "megablock_bwd_dy": "megablock_bwd_mlp_rows",
                "megablock_bwd_mlp_dx1_rows": "ln_bwd_rows", "megablock_bwd_mlp_dao_wide":
                "megablock_bwd_mlp_rows", "megablock_bwd_ln1_rows": "ln_bwd_rows"}


def _wide_case(b, n, e, heads, hidden, gen):
    """_case plus the backward's inputs: the cotangent g, x1, z1, f32 masks
    of rate MB_RATE, dqkv and the f32 residual dx1."""
    import torch

    c = _case(b, n, e, heads, hidden, gen)
    m, f32 = b * n, torch.float32

    def rn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    c.update(g=rn(m, e), x1=rn(m, e), z1=rn(m, hidden), dqkv=rn(m, 3 * e), dx1=rn(m, e, dtype=f32))
    c["m1"], c["m2"] = ((torch.rand((m, e), generator=gen, device="cuda") >= MB_RATE).to(f32)
                        / (1 - MB_RATE) for _ in range(2))
    return c


def check_wide_kernels() -> dict:
    """[wide kernels]: each wide launch against its plain version at DeiT-B's
    G and D shapes (forwards by KERNEL_RTOL * max(1, max|plain|), the
    backward's outputs by KERNEL_RTOL * their own max|plain|), each bit-equal
    across two calls, timed beside its plain version, its bound, the
    library call that computes the same function where one does
    (F.layer_norm for the LN rows) and torch.matmul of its products; the
    four forms whole (the training LN2 -> fc1, LN->qkv, the MLP half, the LN1
    half) timed beside their bounds and products; then each form forced wide
    at highres128's G shape against the resident kernels, the largest
    difference printed.  Returns (records by launch name, at G's shape with
    D's beside; the forms' and the forced comparison's records)."""
    import torch
    import torch.nn.functional as F

    from vitgan_tpu_torch.ops import fused_block as FB
    from vitgan_tpu_torch.ops import fused_mlp as FM

    tag, smi = "[wide kernels]", _smi()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    out = {k: {} for k in WIDE_KERNELS}
    forms = {}
    for label, shape in WIDE_SHAPES:
        c = _wide_case(*shape, gen)
        b, n, e, heads, dh, hidden = c["dims"]
        m, f32 = b * n, torch.float32
        print(f"{tag} {smi}: {label}: B {b} N {n} E {e} heads {heads} hidden {hidden} ({m} rows)")
        x2 = c["x"].reshape(m, e)
        y = FM.ln_rows_reference(x2, c["ln_s"], c["ln_b"])
        wqkv = FB._qkv_weight(c["qkv_w"], torch.bfloat16)
        dmlp = FB.bwd_dmlp_rows_reference(c["g"], c["m2"])
        dz1 = FB.bwd_dz1_stage_reference(dmlp, None, c["z1"], c["w2"])[1]
        dy2 = FB.bwd_dy_reference(dz1, c["w1"])
        da = FB.bwd_dx1_rows_reference(dy2, c["g"], c["m1"], c["x1"], c["ln_s"], c["ln_b"])[1]
        dy1 = FB.bwd_dy_reference(c["dqkv"], wqkv)
        ao = c["attn"].reshape(m, e)
        ln_bf = (c["ln_s"].to(torch.bfloat16), c["ln_b"].to(torch.bfloat16))
        part = -(-m // 64) * 2 * e * 4
        # name: (kernel, plain, forward?, bound (flops, bytes), library call, products)
        calls = {
            "ln_rows": (lambda: FM.ln_rows(x2, c["ln_s"], c["ln_b"]),
                        lambda: FM.ln_rows_reference(x2, c["ln_s"], c["ln_b"]), True,
                        (0.0, 2 * m * e * 2 + 2 * e * 4),
                        lambda: F.layer_norm(x2, (e,), *ln_bf), None),
            "ln_mlp_fc1_wide": (lambda: FM.fc1_stage(y, c["w1"], c["b1"], want_z1=True),
                                lambda: FM.fc1_stage_reference(y, c["w1"], c["b1"]), True,
                                (2.0 * m * e * hidden, m * e * 2 + e * hidden * 2 + hidden * 4
                                 + 2 * m * hidden * 2), None, lambda: y @ c["w1"]),
            "ln_qkv_fwd_wide": (
                lambda: FB.qkv_stage(y.reshape(b, n, e), c["qkv_w"], c["qkv_b"].reshape(-1)),
                lambda: FB.qkv_stage_reference(y.reshape(b, n, e), c["qkv_w"],
                                               c["qkv_b"].reshape(-1)), True,
                (2.0 * m * e * 3 * e, m * e * 2 + 3 * e * e * 2 + 3 * e * 4 + 3 * m * e * 2),
                None, lambda: y @ wqkv),
            "megablock_bwd_mask_rows": (lambda: FB.bwd_dmlp_rows(c["g"], c["m2"]),
                                        lambda: FB.bwd_dmlp_rows_reference(c["g"], c["m2"]),
                                        False, (0.0, m * e * (2 + 4 + 2)), None, None),
            "megablock_bwd_mlp_dz1_wide": (
                lambda: FB.bwd_dz1_stage(dmlp, None, c["z1"], c["w2"])[1:],
                lambda: FB.bwd_dz1_stage_reference(dmlp, None, c["z1"], c["w2"])[1:], False,
                (2.0 * m * e * hidden, m * e * 2 + m * hidden * 2 + hidden * e * 2
                 + 2 * m * hidden * 2), None, lambda: dmlp @ c["w2"].t()),
            "megablock_bwd_dy": (lambda: FB.bwd_dy(dz1, c["w1"]),
                                 lambda: FB.bwd_dy_reference(dz1, c["w1"]), False,
                                 (2.0 * m * hidden * e, m * hidden * 2 + e * hidden * 2
                                  + m * e * 4), None, lambda: dz1 @ c["w1"].t()),
            "megablock_bwd_mlp_dx1_rows": (
                lambda: FB.bwd_dx1_rows(dy2, c["g"], c["m1"], c["x1"], c["ln_s"], c["ln_b"]),
                lambda: FB.bwd_dx1_rows_reference(dy2, c["g"], c["m1"], c["x1"], c["ln_s"],
                                                  c["ln_b"]), False,
                (0.0, m * e * (4 + 2 + 2 + 4) + m * e * (4 + 2 + 2) + part), None, None),
            "megablock_bwd_mlp_dao_wide": (
                lambda: FB.bwd_dao_stage(da, ao, c["wout"], b, n, heads),
                lambda: FB.bwd_dao_stage_reference(da, ao, c["wout"], b, n, heads), False,
                (2.0 * m * e * e, 3 * m * e * 2 + e * e * 2 + m * heads * 4), None,
                lambda: da @ c["wout"].t()),
            "megablock_bwd_ln1_rows": (
                lambda: FB.bwd_ln1_rows(dy1, c["x"].reshape(m, e), c["dx1"], c["ln_s"],
                                        c["ln_b"]),
                lambda: FB.bwd_ln1_rows_reference(dy1, c["x"].reshape(m, e), c["dx1"],
                                                  c["ln_s"], c["ln_b"]), False,
                (0.0, m * e * (4 + 2 + 4) + m * e * (2 + 2) + part), None, None),
        }
        for name, (kern, plain, fwd, (flops, nbytes), library, products) in calls.items():
            got, want = kern(), plain()
            got, want = ((t,) if torch.is_tensor(t) else tuple(t) for t in (got, want))
            err = max(_err(a, w, f"{name} {label} output {i}", own_scale=not fwd)
                      for i, (a, w) in enumerate(zip(got, want)))
            repeat = _repeat(kern, f"{name} {label}")
            bound_ms, bound_by = _bound(flops, nbytes)
            rec = {"max_abs_err": err, "repeat_max_abs_diff": repeat, "ms": _time_ms(kern, 10),
                   "plain_ms": _time_ms(plain, 2), "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": _time_ms(library, 10) if library else None,
                   "device_ms": _device_ms(kern, 10, (WIDE_SYMBOLS[name],))[0]}
            if products is not None:
                rec["products_only_ms"] = _time_ms(products, 10)
                rec["products_only"] = PRODUCTS_ONLY
            if name == "ln_rows":
                rec["library"] = "F.layer_norm on bf16 rows, gamma and beta in bf16"
            print(f"  {name} {label}: {rec['ms']:.4f} ms (device {rec['device_ms']}, plain "
                  f"{rec['plain_ms']:.4f}, library {rec['library_ms']}, products only "
                  f"{rec.get('products_only_ms')}, bound {bound_ms:.4f} ms by {bound_by})")
            if label == "G":
                out[name].update(rec)
            else:
                out[name].update({f"D_{k}": v for k, v in rec.items()
                                  if k in ("max_abs_err", "ms", "bound_ms", "device_ms",
                                           "repeat_max_abs_diff")})
        del calls
        # the four forms whole, as the training block calls them
        seed = torch.randint(0, 2 ** 62, (1,), generator=gen, device="cuda")
        hd, x1 = e, c["x1"]
        fwd_args = (x2, ao, c["wout"], c["bout"], c["ln_s"], c["ln_b"], c["w1"], c["b1"],
                    c["w2"], c["b2"], seed, MB_RATE)
        mlp_args = (c["g"], c["m1"], c["m2"], x1, c["z1"], ao, c["w1"], c["w2"], c["wout"],
                    c["ln_s"], c["ln_b"], b, n, heads)
        ln1_args = (c["dqkv"], c["qkv_w"], x2, c["dx1"], c["ln_s"], c["ln_b"])
        whole = {
            "ln_mlp_train_fwd": (lambda: FB.ln_mlp_train_forward(*fwd_args),
                                 (2.0 * m * hd * e + 4.0 * m * e * hidden,
                                  m * (e + hd) * 2 + (hd * e + 2 * e * hidden) * 2
                                  + 2 * m * e * 2 + m * hidden * 2 + 2 * m * e * 4),
                                 lambda: (ao @ c["wout"], y @ c["w1"], dz1 @ c["w2"])),
            "ln_qkv_fwd": (lambda: FB.ln_qkv_forward(c["x"], c["ln_s"], c["ln_b"], c["qkv_w"],
                                                     c["qkv_b"].reshape(-1)),
                           (2.0 * m * e * 3 * e, m * e * 2 + 3 * e * e * 2 + 3 * m * e * 2),
                           lambda: x2 @ wqkv),
            "megablock_bwd_mlp": (lambda: FB.megablock_bwd_mlp(*mlp_args),
                                  (4.0 * m * e * hidden + 2.0 * m * e * hd,
                                   2 * m * e * 2 + m * hidden * 2 + m * hd * 2 + 2 * m * e * 4
                                   + (2 * e * hidden + hd * e) * 2 + m * e * (2 + 2 + 4 + 2)
                                   + 2 * m * hidden * 2 + m * hd * 2 + b * heads * n * 4),
                                  lambda: (dmlp @ c["w2"].t(), dz1 @ c["w1"].t(),
                                           da @ c["wout"].t())),
            "megablock_bwd_ln1": (lambda: FB.megablock_bwd_ln1(*ln1_args),
                                  (2.0 * m * 3 * hd * e, m * 3 * hd * 2 + m * e * 2 + m * e * 4
                                   + 3 * hd * e * 2 + 2 * m * e * 2),
                                  lambda: c["dqkv"] @ wqkv.t())}
        for name, (call, (flops, nbytes), products) in whole.items():
            bound_ms, bound_by = _bound(flops, nbytes)
            rec = {"ms": _time_ms(call, 10), "bound_ms": bound_ms, "bound_by": bound_by,
                   "products_only_ms": _time_ms(products, 10)}
            print(f"  {name} {label} (wide, whole): {rec['ms']:.4f} ms (products only "
                  f"{rec['products_only_ms']:.4f}, bound {bound_ms:.4f} ms by {bound_by})")
            forms.setdefault(name, {})[label] = rec
        del c, x2, y, wqkv, dmlp, dz1, dy2, da, dy1, ao, whole
        torch.cuda.empty_cache()

    # each form forced wide at highres128's G shape against the resident kernels
    c = _wide_case(*FORCED_SHAPE, gen)
    b, n, e, heads, dh, hidden = c["dims"]
    m = b * n
    print(f"{tag} {smi}: the wide variants forced at E {e} ({m} rows) against the resident "
          "kernels")
    seed = torch.randint(0, 2 ** 62, (1,), generator=gen, device="cuda")
    x2 = c["x"].reshape(m, e)
    fwd_args = (x2, c["attn"].reshape(m, e), c["wout"], c["bout"], c["ln_s"], c["ln_b"],
                c["w1"], c["b1"], c["w2"], c["b2"], seed, MB_RATE)
    mlp_args = (c["g"], c["m1"], c["m2"], c["x1"], c["z1"], c["attn"].reshape(m, e), c["w1"],
                c["w2"], c["wout"], c["ln_s"], c["ln_b"], b, n, heads)
    ln1_args = (c["dqkv"], c["qkv_w"], x2, c["dx1"], c["ln_s"], c["ln_b"])
    pairs = {"ln_mlp_train_fwd": (lambda w: FB.ln_mlp_train_forward(*fwd_args, wide=w), True),
             "ln_qkv_fwd": (lambda w: FB.ln_qkv_forward(c["x"], c["ln_s"], c["ln_b"],
                                                        c["qkv_w"], c["qkv_b"].reshape(-1),
                                                        wide=w), True),
             "megablock_bwd_mlp": (lambda w: FB.megablock_bwd_mlp(*mlp_args, wide=w), False),
             "megablock_bwd_ln1": (lambda w: FB.megablock_bwd_ln1(*ln1_args, wide=w), False)}
    forced = {}
    for name, (call, fwd) in pairs.items():
        wide, resident = call(True), call(False)
        wide, resident = ((t,) if torch.is_tensor(t) else tuple(t) for t in (wide, resident))
        diffs = [_err(a, r, f"{name} forced wide against resident, output {i}",
                      own_scale=not fwd)
                 for i, (a, r) in enumerate(zip(wide, resident)) if a is not None]
        forced[name] = {"max_abs_diff": max(diffs), "wide_ms": _time_ms(lambda: call(True), 10),
                        "resident_ms": _time_ms(lambda: call(False), 10)}
        print(f"  {name} at E {e}: largest |wide - resident| {max(diffs):.6g}; wide "
              f"{forced[name]['wide_ms']:.4f} ms, resident {forced[name]['resident_ms']:.4f} ms")
    del c, x2, fwd_args, mlp_args, ln1_args, pairs
    torch.cuda.empty_cache()
    return out, {"forms": forms, "forced_at_384": forced, "card": smi}


# deit64 at DeiT-B's widths, set as `cli train --set` sets them (not a preset).
DEIT_B = {"v2.embed_dim": 768, "v2.num_heads": 12}
WIDE_STEPS = 3
# The megablock's training launches at E > 384, per block forward that has
# a backward (LN1 and LN2 rows, the streamed qkv, flash, the out-projection
# and fc2 by the linear stage, the streamed fc1) and per saved block
# backward with dropout (the qkv recompute, the MLP half's five launches,
# dy1 and the LN1 rows); the resident LN kernels launch none.
WIDE_FWD_LAUNCHES = {"ln_rows": 2, "ln_qkv_fwd_wide": 1, "flash_attn_fwd": 1,
                     "ln_mlp_train_fwd": 1, "ln_mlp_fc1_wide": 1, "ln_mlp_linear": 2}
WIDE_BWD_LAUNCHES = {"ln_rows": 1, "ln_qkv_fwd_wide": 1, "megablock_bwd_mlp": 1,
                     "megablock_bwd_mask_rows": 1, "megablock_bwd_mlp_dz1_wide": 1,
                     "megablock_bwd_dy": 2, "megablock_bwd_mlp_dx1_rows": 1,
                     "megablock_bwd_mlp_dao_wide": 1, "megablock_bwd_ln1_rows": 1}


def wide_train_kernels(m) -> dict:
    """Launches a step of a v2 model at E > 384 under megablock=auto with
    dropout, remat never (deit64's): its three forwards of ``depth`` blocks
    with their backwards (G; D on [real; fake]; D on the fake in the G
    update), the flash backward on backward_route's choice at G's and D's
    tokens, four weight-gradient products and two LN sums per block backward
    with parameter gradients (D's, then G's)."""
    from vitgan_tpu_torch.ops import attention as A

    per = {}
    for table in (WIDE_FWD_LAUNCHES, WIDE_BWD_LAUNCHES):
        for k, v in table.items():
            per[k] = per.get(k, 0) + 3 * m.depth * v
    n = (m.image_size // m.patch_size) ** 2
    dh = m.embed_dim // m.num_heads
    for tokens, blocks in ((n, m.depth), (n + 1, 2 * m.depth)):
        if A.backward_route(tokens, dh, 2) == "fused":
            per["flash_attn_bwd_fused"] = per.get("flash_attn_bwd_fused", 0) + blocks
        else:
            for k in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
                per[k] = per.get(k, 0) + blocks
    per.update(wgrad_gemm=4 * 2 * m.depth, sum_partials=2 * 2 * m.depth)
    return per


def wide_against_plain(cfg) -> dict:
    """One train step of ``cfg`` at dropout 0 (the megablock's Philox masks
    are not the plain route's draws), from one state, batch, latents and
    augment draws, on the kernel route (megablock=auto: every block on the
    saved wide variants) and on use_pallas=never: held in the route
    comparison's bounds (_hold_route_step; D's head bias, a sum over the D
    update's rows, at the sum of their |dlogit|)."""
    import torch

    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.data.datasets import synthetic_dataset
    from vitgan_tpu_torch.models import build_gan
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.ops.augment import draw_augment
    from vitgan_tpu_torch.ops.policy import get_policy, set_policy
    from vitgan_tpu_torch.train.sample import latent_rng
    from vitgan_tpu_torch.train.state import create_train_state
    from vitgan_tpu_torch.train.step import host_metrics, make_train_step

    tag = "[train deit64 wide routes]"
    cfg = C.replace(cfg, **{"v2.dropout": 0.0})
    b, gan = cfg.v2.batch_size, build_gan(cfg)
    images, _ = synthetic_dataset(b, cfg.v2.image_size, 3, seed=SEED)
    real = torch.from_numpy(images).cuda().float() * (2.0 / 255.0) - 1.0
    z = gan.sample_latent(latent_rng(SEED, 0), b)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    draws = {key: draw_augment(gen, real.to(torch.bfloat16), cfg.run.diff_augment)
             for key in ("aug_real", "aug_fake", "aug_g")}
    dlogit, res = [], {}

    def record(module, args, y):
        if y.requires_grad and y.shape[0] == 2 * b:
            y.register_hook(lambda dy: dlogit.append(dy.detach().float()))

    saved = get_policy()
    state = create_train_state(gan, cfg, device="cuda")
    start = state.state_dict()  # each route's step starts from it
    try:
        for route, policy in (("kernels", dict(mode="auto", megablock="auto")),
                              ("plain", dict(mode="never", megablock="auto"))):
            set_policy(**policy)
            state.load_state_dict(start)
            step = make_train_step(gan, cfg)
            hook = state.d.register_forward_hook(record) if route == "plain" else None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            build.reset_launches()
            t0 = time.perf_counter()
            metrics = host_metrics(step(state, real, z=z, draws=draws))
            sec = time.perf_counter() - t0
            if hook is not None:
                hook.remove()
                head = dict(state.d.named_parameters())["head_fc2.b"].grad.item()
            launched = {k: v for k, v in build.LAUNCHES.items() if v}
            # copied: the next route's step refills the state's gradient tensors
            res[route] = (metrics, [p.grad.float().clone() for p in (*state.g.parameters(),
                                                                     *state.d.parameters())],
                          [f"g.{n}" for n, _ in state.g.named_parameters()]
                          + [f"d.{n}" for n, _ in state.d.named_parameters()])
            res[f"{route}_peak"], res[f"{route}_s"] = torch.cuda.max_memory_allocated(), sec
            print(f"{tag} {route}: one eager step in {sec:.2f} s, peak "
                  f"{res[f'{route}_peak'] / 2**30:.2f} GiB, launches {launched}, metrics {metrics}")
            if route == "plain" and launched:
                raise AssertionError(f"{tag} the plain route launched a kernel")
            wide = launched.get("megablock_bwd_mlp_dz1_wide")
            if route == "kernels" and (wide != 3 * cfg.v2.depth
                                       or launched.get("megablock_bwd_mlp_dz1")):
                raise AssertionError(f"{tag} not every block took the wide variants: {launched}")
            del step
            torch.cuda.empty_cache()
    finally:
        set_policy(**saved)
    del state, start
    if len(dlogit) != 1 or not abs(dlogit[0].sum().item() - head) <= \
            1e-3 * dlogit[0].abs().sum().item():
        raise AssertionError(f"{tag} D's head bias gradient {head} is not the sum of the D "
                             f"update's dlogit ({len(dlogit)} recorded)")
    out = _hold_route_step(f"{tag} kernels against plain:", res["kernels"], res["plain"],
                           {"d.head_fc2.b": dlogit[0].abs().sum().item()})
    out.update({k: res[k] for k in ("kernels_peak", "plain_peak", "kernels_s", "plain_s")})
    return out


def train_deit64_wide(steps: int = WIDE_STEPS) -> dict:
    """[train deit64 wide]: deit64 at DeiT-B's widths (embed 768, 12 heads
    of 64, hidden 3,072, depth 12; 256 tokens in G, 257 in D, batch 64,
    dropout 0.1, DiffAugment) under the preset's megablock=auto through
    Trainer: an eager warm-up step, a warm-up epoch of ``steps`` (the
    capture), then ``steps`` captured steps by fit after _settle: ms/step,
    peak memory, the launches a step asserted (wide_train_kernels: every
    block of G and D on the megablock's wide kernels, no resident LN
    kernel), a profiled breakdown of a captured call; one eager step from
    one state on this route and on use_pallas=never within the route
    comparison's bounds at dropout 0 (wide_against_plain); one batch-64
    serving call of the trained generator on the megablock's inference
    route, its launches."""
    import tempfile

    import numpy as np
    import torch

    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.models import count_params
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.serve import SamplerService
    from vitgan_tpu_torch.train.step import host_metrics
    from vitgan_tpu_torch.train.trainer import Trainer

    tag, smi = "[train deit64 wide]", _smi()
    cfg = C.replace(C.deit64_config(), **DEIT_B, **_fit_over({
        "data.dataset": "synthetic", "data.synthetic_samples": 256, "run.epochs": 2,
        "run.steps_per_epoch": steps}))
    m = cfg.v2
    run_dir = tempfile.mkdtemp(prefix="deit64_wide_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    metrics = None
    try:
        t0 = time.perf_counter()
        trainer = Trainer(cfg, run_dir=run_dir, device="cuda")
        st, metrics = trainer.state, trainer.metrics
        setup = time.perf_counter() - t0
        print(f"{tag} {smi}: deit64 with {DEIT_B}: embed {m.embed_dim}, {m.num_heads} heads, "
              f"hidden {m.embed_dim * m.mlp_ratio}, depth {m.depth}, batch {m.batch_size}, "
              f"{m.image_size} px at patch {m.patch_size}, dropout {m.dropout}, augment "
              f"{cfg.run.diff_augment!r}, megablock {cfg.runtime.megablock}; G "
              f"{count_params(st.g)} D {count_params(st.d)} parameters; set up in {setup:.1f} s")
        t0 = time.perf_counter()
        warm = host_metrics(trainer.train_step(st, trainer.real_batch(trainer.batches()[0])))
        print(f"{tag} 1 eager warm-up step in {time.perf_counter() - t0:.2f} s: {warm}")
        grid = _grid_launches(trainer)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.fit(epochs=1)  # the warm-up epoch, the capture among its steps
        warm_s = time.perf_counter() - t0
        _settle()
        torch.cuda.synchronize()
        build.reset_launches()
        # --- the DeiT-B-width path ---
        means = trainer.fit()
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        # --- end of the DeiT-B-width path ---
        peak = torch.cuda.max_memory_allocated()
        ms = 1e3 * m.batch_size / means["images_per_sec"]
        want = wide_train_kernels(m)
        per_step = _check_fit_launches(tag, launches, want, steps, grid)
        if not all(math.isfinite(means[k]) for k in ("d_loss", "g_loss", "d_grad_norm",
                                                     "g_grad_norm")):
            raise AssertionError(f"{tag} non-finite train metrics: {means}")
        print(f"{tag} {smi}: {steps} captured steps by Trainer.fit: {ms:.2f} ms/step, "
              f"{means['images_per_sec']:.2f} img/s; peak {peak / 2**30:.2f} GiB allocated over "
              f"the capture and both epochs; warm-up epoch {warm_s:.1f} s; launches a step "
              f"{want}")
        breakdown = train_breakdown(trainer, ms, recompute=False)
        trainer._build_device_fns()  # drop the fit's captured graphs and their memory pool
        svc = SamplerService(cfg, trainer.gan, st.g, batch=m.batch_size)
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        imgs = svc.sample(m.batch_size, seed=1)
        serve_ms = 1e3 * (time.perf_counter() - t0)
        served = {k: v for k, v in build.LAUNCHES.items() if v}
        n_img = (m.batch_size, m.image_size, m.image_size, 3)
        if imgs.shape != n_img or not np.isfinite(imgs).all():
            raise AssertionError(f"{tag} serving: {imgs.shape}")
        want_serve = {"ln_rows": 2 * m.depth, "ln_qkv_fwd_wide": m.depth,
                      "flash_attn_fwd": m.depth, "proj_ln_mlp_fwd": m.depth,
                      "ln_mlp_fc1_wide": m.depth, "ln_mlp_linear": 2 * m.depth}
        if served != want_serve:
            raise AssertionError(f"{tag} a batch-{m.batch_size} serving call launched {served}, "
                                 f"expected {want_serve}")
        print(f"{tag} one batch-{m.batch_size} serving call of the trained generator in "
              f"{serve_ms:.1f} ms (host clock): launches {served}")
        del svc, trainer, st
        torch.cuda.empty_cache()
        routes = wide_against_plain(cfg)
    finally:
        _remove_run_dir(run_dir, metrics)
    return {"card": smi, "set": DEIT_B, "ms_per_step": ms, "img_per_s": means["images_per_sec"],
            "peak_allocated_bytes": peak, "setup_s": setup, "warm_epoch_s": warm_s,
            "launches_per_step": {k: v // steps for k, v in per_step.items() if v},
            "launches": per_step, "means": means, "breakdown": breakdown, "routes": routes,
            "serve": {"ms": serve_ms, "launches": served}}


# Kernel launches per highres128 train step at batch 32 (12 blocks; G's
# forward, D's forward on [real; fake] and on fake, and the three backwards).
TRAIN_KERNELS = {
    # runtime.megablock=auto (the preset's default): the megablock's training
    # forward and its saved-residual backward in every block
    "auto": {"ln_qkv_fwd": 72, "flash_attn_fwd": 36, "ln_mlp_train_fwd": 36,
             # its stages: the out-projection and fc2 by the linear kernel
             "ln_mlp_fc1": 36, "ln_mlp_linear": 72,
             "flash_attn_bwd_fused": 12, "flash_attn_bwd_dq": 24, "flash_attn_bwd_dkv": 24,
             "megablock_bwd_mlp": 36, "megablock_bwd_ln1": 36,
             # the MLP half's stages: one launch of each a call
             **{stage: 36 for stage in MB_MLP_STAGES},
             # four weight-gradient products and two LN sums per block backward
             # that has parameter gradients to give: D's, then G's (D's
             # parameters are frozen in the G update); each product's entry
             # runs its own fixed-order reduce of the partials
             "wgrad_gemm": 96, "sum_partials": 48},
    # runtime.megablock=off: flash attention and LN->MLP with their backward
    "off": {"flash_attn_fwd": 36, "flash_attn_bwd_fused": 12, "flash_attn_bwd_dq": 24,
            "flash_attn_bwd_dkv": 24, "ln_mlp_fwd": 36, "ln_mlp_fc1": 36, "ln_mlp_linear": 36},
    # highres256p4 (4,096 tokens, 4,097 in D; the megablock's gate refuses
    # them): flash attention with the single-pass backward in every block of
    # G, of D and of D in the G update (K/V under 4 MiB), and LN->MLP
    "p4": {"flash_attn_fwd": 36, "flash_attn_bwd_fused": 36, "ln_mlp_fwd": 36,
           "ln_mlp_fc1": 36, "ln_mlp_linear": 36},
}
# The megablock's training forward, per block forward: LN->qkv, the flash
# forward and ln_mlp_train_fwd (the out-projection and fc2 by the linear
# stage, LN2 -> fc1 by the fc1 stage).
MB_FWD_LAUNCHES = {"ln_qkv_fwd": 1, "flash_attn_fwd": 1, "ln_mlp_train_fwd": 1,
                   "ln_mlp_fc1": 1, "ln_mlp_linear": 2}


def remat_name(remat) -> str:
    """runtime.remat as ops/policy reads it (True is 'full', False 'never')."""
    if isinstance(remat, bool):
        return "full" if remat else "never"
    return remat


def remat_extra(route: str, remat) -> dict:
    """What runtime.remat re-runs in the backward, per block forward that has
    a backward, as the JAX package's gradient does (tests/test_torch_remat.py
    holds the port's counts to its jaxpr): under full, dots and attn the
    megablock's whole training forward (its residuals are neither products
    nor named); on the standard path under full and dots the flash forward,
    under attn nothing (its output and LSE are kept); the LN->MLP forward
    never (no backward reads its output, models/remat.py)."""
    remat = remat_name(remat)
    if remat == "never":
        return {}
    if route == "auto":
        return dict(MB_FWD_LAUNCHES)
    return {} if remat == "attn" else {"flash_attn_fwd": 1}


def train_kernels(route: str, remat, depth: int = 12, forwards: int = 3) -> dict:
    """TRAIN_KERNELS[route] with remat's re-runs: ``forwards`` forwards of
    ``depth`` blocks each have one backward (G; D on [real; fake]; D on the
    fake in the G update)."""
    per = dict(TRAIN_KERNELS[route])
    for k, v in remat_extra(route, remat).items():
        per[k] = per.get(k, 0) + v * depth * forwards
    return per


def check_training_gate() -> dict:
    """Under the default runtime.megablock=auto the JAX package's gate sends
    highres128's training blocks (G's 1,024 tokens, D's 1,025) through
    encoder_block_fused_dropout_saved; on the card the port takes that
    variant there (a full-width block, a real step generator), and with
    megablock_bwd=recompute or megablock=off the standard path."""
    import torch

    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.models.vitgan_v2 import EncoderBlock
    from vitgan_tpu_torch.ops.fused_block import maybe_megablock, megablock_route
    from vitgan_tpu_torch.ops.policy import get_policy, set_policy

    m = C.highres_config(128).v2
    block = EncoderBlock(m, torch.Generator().manual_seed(SEED)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    saved = get_policy()
    routes = {}
    try:
        set_policy(mode="auto", megablock="auto", megablock_bwd="saved")
        for n in (1024, 1025):
            x = torch.randn((2, n, m.embed_dim), device="cuda").to(torch.bfloat16)
            x.requires_grad_()
            out = maybe_megablock(block, x, m, train=True, generator=gen)
            name = None if out is None else type(out.grad_fn).__name__
            routes[f"auto_{n}"] = megablock_route(block, x, m, True, True)
            print(f"[train gate] megablock=auto, N {n}: {routes[f'auto_{n}']} ({name})")
            if routes[f"auto_{n}"] != "encoder_block_fused_dropout_saved" or \
                    name != "_SavedBlockBackward":
                raise AssertionError(f"megablock=auto did not route N {n} to the saved "
                                     "dropout megablock")
        for policy in (dict(megablock_bwd="recompute"), dict(megablock="off",
                                                            megablock_bwd="saved")):
            set_policy(**policy)
            if maybe_megablock(block, x, m, train=True, generator=gen) is not None:
                raise AssertionError(f"{policy} routed a highres128 training block")
            print(f"[train gate] {policy}, N {n}: the standard path")
    finally:
        set_policy(**saved)
    return routes


def _settle() -> None:
    """Before a timed fit: flush the files the previous fit's epilogue wrote
    (its checkpoint and generator, 2.2 GB at highres128).  A fit that starts
    while the kernel writes them back runs its first seconds slower (the
    highres128 captured step read 139-166 ms against 122 on an H100 80GB HBM3
    at 700 W); a training run's epochs follow no such write."""
    os.sync()


def _remove_run_dir(run_dir: str, metrics=None) -> None:
    """Removes a phase's run directory, closing ``metrics`` (its Trainer's
    MetricLogger, or None) first: TensorBoard's writer thread flushes event
    files into the directory until its writer is closed, and a directory
    removed under it makes that thread print a FileNotFoundError."""
    if metrics is not None:
        metrics.close()
    shutil.rmtree(run_dir, ignore_errors=True)


def _fit_over(over: dict) -> dict:
    """The run settings of every fit-driven phase: no per-epoch grid (fit's
    epilogue still samples one), no FID ([eval] drives it), one checkpoint
    kept."""
    return {"run.log_every_steps": 0, "run.sample_grid_every_epochs": 0,
            "run.fid_every_epochs": 0, "run.keep_checkpoints": 1, **over}


def _grid_launches(trainer) -> dict:
    """Kernel launches of the one sample grid fit's epilogue draws."""
    import torch

    from vitgan_tpu_torch.ops import build

    torch.cuda.synchronize()
    build.reset_launches()
    trainer._save_grids(0)
    torch.cuda.synchronize()
    return {k: v for k, v in build.LAUNCHES.items() if v}


def _check_fit_launches(tag: str, launches: dict, per_step: dict, steps: int,
                        grid: dict) -> dict:
    """Each kernel's launches over a fit of ``steps`` captured steps: its
    count per step (eager's, counted at capture and added per replay) times
    the steps, plus the epilogue's grid.  Returns the steps' share (the
    fit's launches less the grid's)."""
    for name in set(launches) | set(per_step) | set(grid):
        want = per_step.get(name, 0) * steps + grid.get(name, 0)
        if launches.get(name, 0) != want:
            raise AssertionError(f"{tag} {name} launched {launches.get(name, 0)} times, expected "
                                 f"{want} ({per_step.get(name, 0)} a step x {steps} + "
                                 f"{grid.get(name, 0)} for the grid)")
    return {k: v - grid.get(k, 0) for k, v in launches.items()}


def _eager_step_ms(trainer, steps: int) -> float:
    """ms per eager train step (make_train_step), host clock to a sync."""
    import torch

    from vitgan_tpu_torch.train.step import host_metrics

    batches = trainer.batches()[:steps]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for idx in batches:
        m = trainer.train_step(trainer.state, trainer.real_batch(idx))
    host_metrics(m)
    return 1e3 * (time.perf_counter() - t0) / len(batches)


def train_main_path(run_dir: str, route: str = "auto") -> tuple:
    """highres128 at full depth through Trainer under ``route``
    (runtime.megablock, 'auto' the preset's default): 2 eager warm-up steps,
    3 eager steps timed, a warm-up epoch of 5 steps (the step's capture),
    then a timed epoch of 5 captured steps by fit, the launches per step
    asserted, a profiled breakdown of a captured call; the run directory
    restored, one `cli generate` and one HTTP request."""
    import numpy as np
    import torch

    from vitgan_tpu_torch import cli
    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.models import count_params
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.serve import serve
    from vitgan_tpu_torch.train.step import host_metrics
    from vitgan_tpu_torch.train.trainer import Trainer
    from vitgan_tpu_torch.utils.run_dirs import restore_run

    tag = f"[train megablock={route}]"
    steps, eager_steps = 5, 3
    over = _fit_over({"data.dataset": "synthetic", "data.synthetic_samples": 256,
                      "run.epochs": 2, "run.steps_per_epoch": steps})
    if route != "auto":
        over["runtime.megablock"] = route
    cfg = C.replace(C.highres_config(128), **over)
    m = cfg.v2
    t0 = time.perf_counter()
    trainer = Trainer(cfg, run_dir=run_dir, device="cuda")
    st = trainer.state
    print(f"{tag} highres128: batch {m.batch_size}, depth {m.depth}, "
          f"{cfg.runtime.compute_dtype}, dropout {m.dropout}, augment {cfg.run.diff_augment!r}, "
          f"loss {m.loss}, megablock {cfg.runtime.megablock}, megablock_bwd "
          f"{cfg.runtime.megablock_bwd}; G {count_params(st.g)} D {count_params(st.d)} "
          f"parameters; set up in {time.perf_counter() - t0:.1f} s")
    before = [p.detach().cpu().clone() for p in (*st.g.parameters(), *st.d.parameters())]
    t0 = time.perf_counter()
    for idx in trainer.batches()[:2]:  # warm-up
        warm = host_metrics(trainer.train_step(st, trainer.real_batch(idx)))
    print(f"{tag} 2 warm-up steps in {time.perf_counter() - t0:.2f} s: {warm}")
    eager_ms = _eager_step_ms(trainer, eager_steps)
    grid = _grid_launches(trainer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()  # the capture's allocations count, the replays' none
    t0 = time.perf_counter()
    trainer.fit(epochs=1)  # the warm-up epoch: its first step runs eagerly, then is captured
    print(f"{tag} warm-up epoch ({steps} steps, the capture among them) in "
          f"{time.perf_counter() - t0:.2f} s")
    _settle()
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    # --- the main path ---
    means = trainer.fit()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    # --- end of the main path ---
    sec = time.perf_counter() - t0
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    img_s = means["images_per_sec"]  # fit's clock: the steps and the epoch's metric readback
    ms = 1e3 * m.batch_size / img_s
    print(f"{tag} {steps} captured steps by Trainer.fit: {ms:.2f} ms/step, {img_s:.2f} img/s "
          f"({sec:.3f} s with the checkpoint and the run directory's write), peak "
          f"{peak / 2**30:.2f} GiB allocated ({reserved / 2**30:.2f} reserved) over the capture "
          f"and both epochs; the eager step in this call {eager_ms:.2f} ms ({eager_steps} steps)")
    print(f"{tag} epoch means: {means}")
    print(f"{tag} launches over {steps} steps and the epilogue's grid: {launches}; the grid's "
          f"alone: {grid}")
    launches = _check_fit_launches(tag, launches, train_kernels(route, cfg.runtime.remat),
                                   steps, grid)
    if not all(math.isfinite(means[k]) for k in ("d_loss", "g_loss", "d_grad_norm",
                                                 "g_grad_norm")):
        raise AssertionError(f"non-finite train metrics: {means}")
    after = [p.detach().cpu() for p in (*st.g.parameters(), *st.d.parameters())]
    moved = sum(not torch.equal(a, b) for a, b in zip(before, after))
    print(f"{tag} {moved} of {len(after)} parameter tensors moved")
    if moved != len(after):
        raise AssertionError("some parameters did not move")
    del before, after
    breakdown = train_breakdown(trainer, ms, recompute=route == "off")
    trainer.metrics.close()  # its writer thread, before the caller removes run_dir
    del trainer, st
    torch.cuda.empty_cache()
    rcfg, _, g, meta = restore_run(run_dir, device="cuda")
    if meta.get("step") != 2 + eager_steps + 2 * steps or rcfg.v2 != m:
        raise AssertionError(f"restored run: meta {meta}")
    del g
    if cli.main(["generate", "--run-dir", run_dir, "--num-images", "16", "--seed", "3"]) != 0:
        raise AssertionError("cli generate failed")
    z = np.load(os.path.join(run_dir, "test", "noise.npy"))
    png = os.path.join(run_dir, "test", "generated_images.png")
    with open(png, "rb") as f:
        h, w = _png_shape(f.read())
    if z.shape != (16, m.latent_dim) or (h, w) != (4 * 130 + 2, 4 * 130 + 2):
        raise AssertionError(f"cli generate wrote {z.shape} latents, a {h}x{w} grid")
    print(f"{tag} restored step {meta['step']} and `cli generate` wrote a {h}x{w} grid")
    httpd = serve(run_dir, host="127.0.0.1", port=0, batch=8)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        status, _, body, req_ms = _post(f"http://127.0.0.1:{httpd.server_address[1]}",
                                        {"n": 4, "seed": 1, "format": "npy"})
    finally:
        httpd.shutdown()
        httpd.server_close()
    arr = np.load(io.BytesIO(body))
    if status != 200 or arr.shape != (4, 128, 128, 3) or not np.isfinite(arr).all():
        raise AssertionError(f"serving the trained run directory: {status} {arr.shape}")
    print(f"{tag} the trained run directory served POST npy n=4 in {req_ms:.1f} ms")
    return launches, {"ms_per_step": ms, "eager_ms_per_step": eager_ms, "img_per_s": img_s,
                      "peak_allocated_bytes": peak, "peak_reserved_bytes": reserved,
                      "depth": m.depth, "means": means, "breakdown": breakdown}


def train_deit64(steps: int = 3) -> dict:
    """deit64 at full width (64 px, 256 tokens + CLS, embed 192, 3 heads,
    hidden 768, depth 12, dropout 0.1, DiffAugment color,translation,cutout)
    under the preset's default runtime (megablock=auto) through Trainer: one
    eager warm-up step, a warm-up epoch of ``steps`` (the capture), then
    ``steps`` captured steps by fit, the megablock's training kernels in
    every block."""
    import tempfile

    import torch

    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.train.step import host_metrics
    from vitgan_tpu_torch.train.trainer import Trainer

    cfg = C.replace(C.deit64_config(), **_fit_over({
        "data.dataset": "synthetic", "data.synthetic_samples": 256, "run.epochs": 2,
        "run.steps_per_epoch": steps}))
    m = cfg.v2
    run_dir = tempfile.mkdtemp(prefix="deit64_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    metrics = None
    try:
        trainer = Trainer(cfg, run_dir=run_dir, device="cuda")
        metrics = trainer.metrics
        host_metrics(trainer.train_step(trainer.state, trainer.real_batch(trainer.batches()[0])))
        grid = _grid_launches(trainer)
        trainer.fit(epochs=1)  # the warm-up epoch, the capture among its steps
        _settle()
        torch.cuda.synchronize()
        build.reset_launches()
        # --- the deit64 path ---
        means = trainer.fit()
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        # --- end of the deit64 path ---
    finally:
        _remove_run_dir(run_dir, metrics)
    ms = 1e3 * m.batch_size / means["images_per_sec"]
    print(f"[train deit64] batch {m.batch_size}, {m.image_size} px, embed {m.embed_dim}, heads "
          f"{m.num_heads}, depth {m.depth}, dropout {m.dropout}, augment "
          f"{cfg.run.diff_augment!r}: {steps} captured steps by Trainer.fit, {ms:.1f} ms/step; "
          f"launches {launches}; means {means}")
    for name, per_block in (("ln_mlp_train_fwd", 1), ("megablock_bwd_mlp", 1),
                            ("megablock_bwd_ln1", 1),
                            *LN_MLP_STAGES["ln_mlp_train_fwd"].items(),
                            *((stage, 1) for stage in MB_MLP_STAGES)):
        if launches[name] != 3 * m.depth * steps * per_block + grid.get(name, 0):
            raise AssertionError(f"deit64: {name} launched {launches[name]} times")
    if launches["ln_mlp_fwd"] != grid.get("ln_mlp_fwd", 0) or not all(
            math.isfinite(means[k]) for k in ("d_loss", "g_loss")):
        raise AssertionError(f"deit64 did not train through the megablock: {means}")
    return {"ms_per_step": ms, "launches": launches, "means": means}


# Kernel names of the port, by the substring of their CUDA symbol (with a
# parent's mma.sync `l2` single pass and its scale-and-cast pass, which
# scripts/kernel_ab.py --v1-fused measures).
PORT_KERNELS = (("flash_bwd_kv_wgmma_kernel", "flash backward k-block (single-pass or dk/dv)"),
                ("flash_bwd_kv_kernel", "flash backward k-block (single-pass or dk/dv)"),
                ("flash_bwd_dkv_l2_kernel", "flash backward k-block (single-pass or dk/dv)"),
                ("flash_bwd_fused_l2_kernel", "flash backward k-block (single-pass or dk/dv)"),
                ("flash_bwd_dq_kernel", "flash backward dq"),
                ("flash_bwd_dq_l2_kernel", "flash backward dq"),
                ("scale_cast_kernel", "flash single-pass `l2` dq finish"),
                ("flash_attn_fwd_kernel", "flash forward"),
                ("flash_fwd_l2_kernel", "flash forward"),
                # the f32 flash kernels (csrc/flash_f32.cuh; the k-block kernel on
                # TF32 wgmma in csrc/flash_f32_bwd.cuh, its mma.sync name kept for a
                # parent tree that scripts/kernel_ab.py measures)
                ("flash_fwd_f32_kernel", "flash forward (f32)"),
                ("flash_bwd_dq_f32_kernel", "flash backward dq (f32)"),
                ("flash_bwd_kv_f32_kernel", "flash backward k-block (f32 single-pass or dk/dv)"),
                ("flash_bwd_kv_tf32_kernel", "flash backward k-block (f32 single-pass or dk/dv)"),
                ("ln_qkv", "LN->qkv forward"),
                ("megablock_bwd_mlp", "megablock backward, MLP half"),
                ("megablock_bwd_ln1", "megablock backward, LN1 half"),
                # the wide variants' row kernels (E > 384; the streamed
                # products are the kernels above with kStream true, the LN1
                # half's dy1 among the MLP half's), templated on the element
                # type (float or __nv_bfloat16) since the f32 backward
                ("ln_rows_kernel", "LayerNorm rows (wide LN->qkv, LN->fc1)"),
                ("mask_rows_kernel", "megablock backward, MLP half"),
                ("ln_bwd_rows_kernel<0,", "megablock backward, MLP half"),
                ("ln_bwd_rows_kernel<1,", "megablock backward, LN1 half"),
                ("ln_bwd_rows_kernel", "megablock backward, LayerNorm rows"),
                # the f32 kernels (csrc/ln_f32.cuh, tile_f32.cuh,
                # wgrad_gemm_f32.cu), before the library test below, which
                # their `gemm` would match: the A . W^T tile by its epilogue
                # (tile_f32_kernel<EPI, ACT>), the LayerNorm forward's rows
                # apart, the A^T . B product (wgrad_tf32_kernel); then a
                # parent's mma.sync forward (ln_gemm_f32_kernel<LN, EPI, ACT>,
                # ln_stats_f32_kernel), A . W^T tile (dy_gemm_f32_kernel<EPI>)
                # and A^T . B (wgrad_f32_kernel), which scripts/kernel_ab.py
                # measures
                ("tile_f32_kernel<0,", "megablock backward f32: dz1 (A.W^T tile)"),
                ("tile_f32_kernel<1,", "megablock backward f32: dy2, dy1 (A.W^T tile)"),
                ("tile_f32_kernel<2,", "megablock backward f32: dao, delta (A.W^T tile)"),
                ("tile_f32_kernel<3,", "LN->fc1 (f32)"),
                ("tile_f32_kernel<4,", "linear stage: fc2, out-projection (f32)"),
                ("tile_f32_kernel<5,", "LN->qkv (f32)"),
                ("tile_f32_kernel", "f32 A.W^T tile"),
                ("ln_norm_f32_kernel", "LayerNorm forward rows (f32)"),
                ("ln_stats_f32_kernel", "LayerNorm forward statistics (f32)"),
                ("ln_gemm_f32_kernel<true, 0,", "LN->fc1 (f32)"),
                ("ln_gemm_f32_kernel<false, 1,", "linear stage: fc2, out-projection (f32)"),
                ("ln_gemm_f32_kernel<true, 2,", "LN->qkv (f32)"),
                ("ln_gemm_f32_kernel", "LayerNorm-family forward (f32)"),
                ("dy_gemm_f32_kernel<0>", "megablock backward f32: dz1 (A.W^T tile)"),
                ("dy_gemm_f32_kernel<1>", "megablock backward f32: dy2, dy1 (A.W^T tile)"),
                ("dy_gemm_f32_kernel<2>", "megablock backward f32: dao, delta (A.W^T tile)"),
                ("dy_gemm_f32_kernel", "megablock backward f32 (A.W^T tile)"),
                ("wgrad_tf32_kernel", "weight-gradient products (f32)"),
                ("wgrad_f32_kernel", "weight-gradient products (f32)"),
                ("wgrad_gemm", "weight-gradient products"),
                ("wgrad_reduce", "weight-gradient products"),
                ("sum_partials", "second-pass sums"))
# ln_mlp_fwd.cu's two stage kernels serve all three LN->MLP forms; a train
# step runs one form, which its route names.
LN_MLP_GROUP = {"auto": "megablock training forward (ln_mlp_train_fwd)",
                "off": "LN->MLP forward"}


def _kernel_group(name: str, route: str) -> str:
    if LN_MLP_SYMBOL in name:
        return LN_MLP_GROUP[route]
    for key, label in PORT_KERNELS:
        if key in name:
            if label.startswith("flash"):  # the score mode: the last template argument
                start = name.find("<", name.find(key))
                last = name[start + 1:name.find(">", start)].split(",")[-1].strip()
                label += {"1": " [l2]", "2": " [l2ref]"}.get(last, "")
            return label
    low = name.lower()
    if "gemm" in low or "xmma" in low or "cutlass" in low or "sm90" in low:
        return "library matrix products (cuBLAS/CUTLASS)"
    if "multi_tensor" in low or "adam" in low:
        return "optimizer"
    return "other elementwise and reductions"


def train_breakdown(trainer, step_ms: float, recompute: bool) -> dict:
    """Where a train step's device time goes: torch.profiler over one
    captured device call of the trainer (its replays), kernel time summed by
    group (the LN->MLP stage kernels under the group of the step's route:
    ``recompute`` is the megablock=off route), and the device's idle share of
    the wall time; where the profiler sees no device time inside the replays,
    2 eager steps instead, and says so.  Then, with ``recompute``, the
    LN->MLP recompute backward alone at the step's three row counts: the
    autograd Function's backward as the port runs it (the plain forward
    recomputed and differentiated, TF32 products), and the same forward and
    backward of the plain version in full f32."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vitgan_tpu_torch.ops import fused_mlp as FM

    st = trainer.state
    _settle()

    def profiled(captured: bool):
        idx = trainer.batches()
        steps = len(idx) if captured else 2
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if captured:
                trainer._device_train_fn(st, trainer.dataset, idx)
            else:
                for i in range(steps):
                    trainer.train_step(st, trainer.real_batch(idx[i]))
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
        rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
                for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        return rows, wall_ms, steps

    rows, wall_ms, steps = profiled(True)
    how = f"one captured call of {steps} steps"
    if not rows or sum(r[1] for r in rows) == 0:
        print("[breakdown] the profiler recorded no device time inside the graph replays: "
              "the breakdown below is of 2 eager steps")
        rows, wall_ms, steps = profiled(False)
        how = "2 eager steps"
    out = {"profiled_wall_ms_per_step": wall_ms, "profiled": how}
    if not rows or sum(r[1] for r in rows) == 0:
        print("[breakdown] the profiler recorded no device time: not measured")
    else:
        busy = sum(r[1] for r in rows)
        groups: dict = {}
        route = "off" if recompute else "auto"
        for name, t, _ in rows:
            key = _kernel_group(name, route)
            groups[key] = groups.get(key, 0.0) + t
        print(f"[breakdown] per step under the profiler ({how}): wall {wall_ms:.2f} ms, device "
              f"busy {busy:.2f} ms; idle {100 * (1 - busy / step_ms):.1f}% of the unprofiled "
              f"{step_ms:.2f} ms step ({100 * (1 - busy / wall_ms):.1f}% of the profiled one)")
        for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"  {g}: {t:.3f} ms ({100 * t / busy:.1f}%)")
        print("[breakdown] top kernels per step (ms, launches):")
        for name, t, n in sorted(rows, key=lambda r: -r[1])[:15]:
            print(f"  {t:8.3f} ms {n:5d}  {name[:110]}")
        out.update({"device_busy_ms_per_step": busy, "idle_share": 1 - busy / step_ms,
                    "idle_share_profiled": 1 - busy / wall_ms, "groups_ms_per_step": groups})
    if not recompute:
        return out
    # LN->MLP's recompute backward (autograd of the plain version) at the
    # step's row counts: G, D on [real; fake], D on fake.
    cfg = trainer.cfg.v2
    e, hidden = cfg.embed_dim, cfg.embed_dim * cfg.mlp_ratio
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    n_tok = (cfg.image_size // cfg.patch_size) ** 2
    recompute = {}
    for mode in ("tf32", "f32"):
        total = 0.0
        for rows_ in (cfg.batch_size * n_tok, 2 * cfg.batch_size * (n_tok + 1),
                      cfg.batch_size * (n_tok + 1)):
            x = torch.randn((rows_, e), generator=gen, device="cuda").to(torch.bfloat16)
            w = [torch.randn(s, generator=gen, device="cuda") * sc for s, sc in
                 (((e,), 0.1), ((e,), 0.1), ((e, hidden), 0.02), ((hidden,), 0.1),
                  ((hidden, e), 0.02), ((e,), 0.1))]
            leaves = [x.requires_grad_(), *(t.requires_grad_() for t in w)]
            y = FM.fused_ln_mlp(*leaves, "gelu", 1e-5, False)
            gy = torch.randn_like(y)
            if mode == "tf32":
                total += _time_ms(lambda: torch.autograd.grad(y, leaves, gy, retain_graph=True), 3)
            else:
                total += _time_ms(lambda: torch.autograd.grad(
                    FM._reference(*leaves, "gelu", 1e-5, False), leaves, gy), 3)
            del x, w, leaves, y, gy
        recompute[mode] = cfg.depth * total
    print(f"[breakdown] LN->MLP recompute backward per step (12 blocks x 3 row counts): "
          f"{recompute['tf32']:.1f} ms with TF32 products (the port's), {recompute['f32']:.1f} "
          f"ms in full f32")
    out["ln_mlp_recompute_ms_per_step"] = recompute
    return out


def compare_train_routes() -> dict:
    """One train step at full width, batch 8, dropout 0, from the same state,
    batch, latents and augment draws, on the megablock=off kernel route, on
    the megablock=auto route (the saved megablock kernels in every block),
    on the megablock=auto route again and on use_pallas=never; each kernel
    route held to the plain one, and the two auto steps compared bit for bit
    (reported: which gradient leaves differ, not held)."""
    import torch

    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.data.datasets import synthetic_dataset
    from vitgan_tpu_torch.models import build_gan
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.ops.augment import draw_augment
    from vitgan_tpu_torch.ops.policy import get_policy, set_policy
    from vitgan_tpu_torch.train.sample import latent_rng
    from vitgan_tpu_torch.train.state import create_train_state
    from vitgan_tpu_torch.train.step import host_metrics, make_train_step

    cfg = C.replace(C.highres_config(128), **{"v2.batch_size": 8, "v2.dropout": 0.0})
    gan = build_gan(cfg)
    images, _ = synthetic_dataset(8, 128, 3, seed=SEED)
    real = torch.from_numpy(images).cuda().float() * (2.0 / 255.0) - 1.0
    z = gan.sample_latent(latent_rng(SEED, 0), 8)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    probe = real.to(torch.bfloat16)
    draws = {key: draw_augment(gen, probe, cfg.run.diff_augment)
             for key in ("aug_real", "aug_fake", "aug_g")}
    saved = get_policy()
    res = {}
    routes = (("megablock_off", dict(mode="auto", megablock="off"), "ln_mlp_fwd"),
              ("megablock_auto", dict(mode="auto", megablock="auto"), "megablock_bwd_mlp"),
              ("megablock_auto_again", dict(mode="auto", megablock="auto"), "megablock_bwd_mlp"),
              ("plain", dict(mode="never", megablock="auto"), None))
    state = create_train_state(gan, cfg, device="cuda")
    start = state.state_dict()  # each route's step starts from it
    try:
        for route, policy, must_launch in routes:
            set_policy(**policy)
            state.load_state_dict(start)
            step = make_train_step(gan, cfg)
            build.reset_launches()
            t0 = time.perf_counter()
            metrics = host_metrics(step(state, real, z=z, draws=draws))
            sec = time.perf_counter() - t0
            # copied: the next route's step refills the state's gradient tensors
            res[route] = (metrics, [p.grad.float().clone() for p in (*state.g.parameters(),
                                                                     *state.d.parameters())],
                          [f"g.{n}" for n, _ in state.g.named_parameters()]
                          + [f"d.{n}" for n, _ in state.d.named_parameters()])
            print(f"[train routes] {route}: {sec:.2f} s, launches {dict(build.LAUNCHES)}, "
                  f"metrics {metrics}")
            if route == "plain" and any(build.LAUNCHES.values()):
                raise AssertionError("the plain route launched a kernel")
            if must_launch and build.LAUNCHES[must_launch] != 36:
                raise AssertionError(f"{route}: {must_launch} did not run in every block")
            del step
            torch.cuda.empty_cache()
    finally:
        set_policy(**saved)
    del state, start
    mp, gp, names = res["plain"]
    out = {}
    (m1, g1, _), (m2, g2, _) = res["megablock_auto"], res["megablock_auto_again"]
    differ = [name for name, a, b in zip(names, g1, g2) if not torch.equal(a, b)]
    out["auto_repeat"] = {"leaves": len(names), "not_bit_equal": differ,
                          "metrics_equal": m1 == m2,
                          "max_abs_diff": max(((a - b).abs().max().item() for a, b in zip(g1, g2)),
                                              default=0.0)}
    print(f"[train routes] megablock_auto twice from one state, batch and draws: "
          f"{len(names) - len(differ)} of {len(names)} gradient leaves bit-equal, metrics "
          f"{'equal' if m1 == m2 else 'differ'}; not bit-equal: {differ} (max |d| "
          f"{out['auto_repeat']['max_abs_diff']:.3g}; reported, not held)")
    for route in ("megablock_off", "megablock_auto"):
        mk, gk, _ = res[route]
        r = out[route] = {}
        for key in ("d_loss", "g_loss"):
            r[key] = abs(mk[key] - mp[key])
            print(f"[train routes] {route} {key}: kernels {mk[key]:.6f} plain {mp[key]:.6f} "
                  f"(|d| {r[key]:.3g}, tolerance {LOSS_TOL})")
            if not r[key] <= LOSS_TOL:
                raise AssertionError(f"{route}: {key} differs from the plain route")
        for key in ("d_grad_norm", "g_grad_norm"):
            r[key] = abs(mk[key] - mp[key]) / mp[key]
            print(f"[train routes] {route} {key}: kernels {mk[key]:.6f} plain {mp[key]:.6f} "
                  f"(relative {r[key]:.3g}, tolerance {NORM_RTOL})")
            if not r[key] <= NORM_RTOL:
                raise AssertionError(f"{route}: {key} differs from the plain route")
        worst, worst_name = 0.0, ""
        for name, a, b in zip(names, gk, gp):
            rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
            if not math.isfinite(rel) or rel > worst:
                worst, worst_name = rel, name
        r["worst_leaf_rel"], r["worst_leaf"] = worst, worst_name
        print(f"[train routes] {route}: {len(names)} gradient leaves, worst max|d| / max|plain| "
              f"{worst:.4g} at {worst_name} (tolerance {LEAF_RTOL})")
        if not worst <= LEAF_RTOL:
            raise AssertionError(f"{route}: a gradient leaf differs from the plain route")
    return out


L2_SHAPES = (("D", (256, 4, 50, 108)), ("D64", (256, 4, 64, 108)), ("D65", (256, 4, 65, 108)),
             ("ragged", (4, 4, 1025, 108)), ("wide", (8, 6, 1024, 64)))
L2_MAIN_SHAPE = "D"
# The CUDA symbols of each flash wrapper's own kernels, for _device_ms: this
# tree's (the `l2` forward and single pass are flash_fwd_l2_kernel and
# flash_bwd_fused_l2_kernel) and the mma.sync `l2` forward and single pass of
# a parent tree (flash_attn_fwd_kernel<DP, MODE>, the `dot` forward's name
# too; flash_bwd_kv_kernel and its dq scale-and-cast pass), so that
# scripts/kernel_ab.py measures both trees.
FLASH_SYMBOLS = {"flash_attn_fwd": ("flash_attn_fwd_kernel", "flash_fwd_l2_kernel"),
                 "flash_attn_bwd_fused": ("flash_bwd_kv_kernel", "flash_bwd_kv_wgmma_kernel",
                                          "scale_cast_kernel", "flash_bwd_fused_l2_kernel"),
                 "flash_attn_bwd_dq": ("flash_bwd_dq_kernel", "flash_bwd_dq_l2_kernel"),
                 "flash_attn_bwd_dkv": ("flash_bwd_kv_kernel", "flash_bwd_kv_wgmma_kernel",
                                        "flash_bwd_dkv_l2_kernel")}


def _with_device_ms(rec: dict, fn, iters: int, base: str) -> dict:
    """``rec`` with the device time per call of the wrapper ``fn``: its own
    kernels (device_ms) and the rest (other_device_ms)."""
    rec["device_ms"], rec["other_device_ms"] = _device_ms(fn, iters, FLASH_SYMBOLS[base])
    return rec


def _l2_library(q, k, v, inv: float):
    """scaled_dot_product_attention computing the `l2` softmax: the |q|^2
    term is constant along a row, so softmax(-inv d2) = softmax(2 inv q.k -
    inv |k|^2) but for the max(., 0) clamp.  A timing reference only."""
    import torch.nn.functional as F

    mask = (-inv * (k.detach().float() ** 2).sum(-1))[:, :, None, :].to(q.dtype)
    return lambda q_=q, k_=k, v_=v: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=mask,
                                                                   scale=2.0 * inv)


def check_l2_kernels() -> dict:
    """The `l2`/`l2ref` forward and the `l2` backward kernels against their
    plain versions on the same bf16 inputs at L2_SHAPES, timed beside their
    bounds, their plain versions and (`l2`) SDPA with the key mask.  Returns
    {"name[mode]": record}; the record at the discriminator's shape."""
    import torch

    from vitgan_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    bwd = {"flash_attn_bwd_fused": (A.flash_backward_fused, A.flash_bwd_fused_reference, 5, 3),
           "flash_attn_bwd_dq": (A.flash_backward_dq, A.flash_bwd_dq_reference, 3, 1),
           "flash_attn_bwd_dkv": (A.flash_backward_dkv, A.flash_bwd_dkv_reference, 4, 2)}
    out = {k: {} for k in ("flash_attn_fwd[l2]", "flash_attn_fwd[l2ref]",
                           *(f"{name}[l2]" for name in bwd))}
    for label, shape in L2_SHAPES:
        b, h, n, dh = shape
        scale = float(h * dh)  # the v1 MHSA's softmax scale, H * Dh
        inv = 1.0 / math.sqrt(scale)
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        print(f"[l2 kernels] {label}: B {b} H {h} N {n} Dh {dh}, scale {scale:g}")
        elem = b * h * n * dh * 2
        iters = 20 if n < 512 else 10
        recs = {}
        for mode in ("l2", "l2ref"):
            name = f"flash_attn_fwd[{mode}]"
            kern = lambda mode=mode: A.flash_forward(q, k, v, scale, score_mode=mode)  # noqa: E731
            plain = lambda mode=mode: A.attention_forward_reference(q, k, v, scale, mode)  # noqa
            (o, lse), (po, plse) = kern(), plain()
            err = _err(o, po, f"{name} {label}")
            contiguous = o.is_contiguous()
            if not contiguous and STRICT:
                raise AssertionError(f"{name} {label}: the output is not contiguous")
            lse_err = (lse - plse).abs().max().item()
            print(f"  {name} {label} lse: max_abs_err {lse_err:.6g} (tolerance 1e-2)")
            if not lse_err <= 1e-2:
                raise AssertionError(f"{name}: LSE disagrees with the plain logsumexp")
            library = _l2_library(q, k, v, inv) if mode == "l2" else None
            bound_ms, bound_by = _bound(4.0 * b * h * n * n * dh, 4 * elem + b * h * n * 4)
            recs[name] = {"max_abs_err": err, "lse_max_abs_err": lse_err, "contiguous": contiguous,
                          "ms": _time_ms(kern, iters), "plain_ms": _time_ms(plain, 3),
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": _time_ms(library, iters) if library else None}
            if label == L2_MAIN_SHAPE:
                _with_device_ms(recs[name], kern, iters, "flash_attn_fwd")
            if library:
                lib_err = (library().float() - po.float()).abs().max().item()
                print(f"  SDPA with the key mask against the plain `l2`: max |d| {lib_err:.4g} "
                      "(the mask in bf16; not a check)")
            del o, lse, po, plse
        o, lse = A.flash_forward(q, k, v, scale, score_mode="l2")
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lib_out = _l2_library(qg, kg, vg, inv)()
        library_ms = _time_ms(lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do,
                                                          retain_graph=True), iters)
        for base, (kern, plain, products, writes) in bwd.items():
            name = f"{base}[l2]"
            args = (q, k, v, o, lse, do, scale)
            got = kern(*args, score_mode="l2")
            want = plain(*args, score_mode="l2")
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(_err(g_, w_, f"{name} {label} out{i}", own_scale=True)
                      for i, (g_, w_) in enumerate(zip(got, want)))
            contiguous = all(g_.is_contiguous() for g_ in got)
            if not contiguous and STRICT:
                raise AssertionError(f"{name} {label}: the outputs are not contiguous")
            del got, want
            repeat = _repeat(lambda: kern(*args, score_mode="l2"), f"{name} {label}")
            bound_ms, bound_by = _bound(2.0 * products * b * h * n * n * dh,
                                        (5 + writes) * elem + b * h * n * 4)
            recs[name] = {"max_abs_err": err,
                          "ms": _time_ms(lambda: kern(*args, score_mode="l2"), iters),
                          "plain_ms": _time_ms(lambda: plain(*args, score_mode="l2"), 3),
                          "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                          "repeat_max_abs_diff": repeat, "contiguous": contiguous}
            if label == L2_MAIN_SHAPE:
                _with_device_ms(recs[name], lambda: kern(*args, score_mode="l2"), iters, base)
        for name, r in recs.items():
            dev = (f"; on the device {r['device_ms']} ms in its kernels, {r['other_device_ms']} ms "
                   "in the wrapper's other work" if "device_ms" in r else "")
            print(f"  {name} {label}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
                  f"{r['library_ms']}, bound {r['bound_ms']:.4f} ms by {r['bound_by']}{dev})")
            if label == L2_MAIN_SHAPE:
                out[name].update(r)
            else:
                out[name][f"{label}_max_abs_err"] = r["max_abs_err"]
                out[name][f"{label}_ms"] = r["ms"]
                out[name][f"{label}_contiguous"] = r["contiguous"]
                if "repeat_max_abs_diff" in r:
                    out[name][f"{label}_repeat_max_abs_diff"] = r["repeat_max_abs_diff"]
        del q, k, v, do, o, lse, qg, kg, vg, lib_out
        torch.cuda.empty_cache()
    return out


# The v1 generator's attention at the reference defaults: batch 128, 4 heads
# of 96 over 32 tokens, softmax scale H * Dh = 384 (`dot`; the single-pass
# backward at 32 tokens).
V1_G_SHAPE, V1_G_SCALE = (128, 4, 32, 96), 384.0


def check_v1_dot_kernels() -> dict:
    """The `dot` forward and single-pass backward kernels, as the v1
    generator runs them (their Dh 96 instantiations), against their plain
    versions on the same bf16 inputs at V1_G_SHAPE: o within KERNEL_RTOL *
    max(1, max|plain|), the LSE within 1e-2, each gradient within KERNEL_RTOL
    * its own max|plain|; timed beside the bound, the plain version, SDPA
    (forward; backward) and the wrapper's device time.  Returns {name: record}."""
    import torch
    import torch.nn.functional as F

    from vitgan_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    b, h, n, dh = V1_G_SHAPE
    scale = V1_G_SCALE
    q, k, v, do = (torch.randn(V1_G_SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    print(f"[v1 dot kernels] G: B {b} H {h} N {n} Dh {dh}, scale {scale:g}")
    elem, iters = b * h * n * dh * 2, 20
    fwd = lambda: A.flash_forward(q, k, v, scale)  # noqa: E731
    fwd_plain = lambda: A.attention_forward_reference(q, k, v, scale, "dot")  # noqa: E731
    (o, lse), (po, plse) = fwd(), fwd_plain()
    err = _err(o, po, "flash_attn_fwd v1 G")
    lse_err = (lse - plse).abs().max().item()
    print(f"  flash_attn_fwd v1 G lse: max_abs_err {lse_err:.6g} (tolerance 1e-2)")
    if not lse_err <= 1e-2:
        raise AssertionError("flash_attn_fwd at v1 G: LSE disagrees with the plain logsumexp")
    inv = 1.0 / math.sqrt(scale)
    bound_ms, bound_by = _bound(4.0 * b * h * n * n * dh, 4 * elem + b * h * n * 4)
    out = {"flash_attn_fwd": _with_device_ms(
        {"shape": list(V1_G_SHAPE), "scale": scale, "max_abs_err": err, "lse_max_abs_err": lse_err,
         "ms": _time_ms(fwd, iters), "plain_ms": _time_ms(fwd_plain, 3), "bound_ms": bound_ms,
         "bound_by": bound_by,
         "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=inv),
                                iters)}, fwd, iters, "flash_attn_fwd")}
    args = (q, k, v, o, lse, do, scale)
    got, want = A.flash_backward_fused(*args), A.flash_bwd_fused_reference(*args)
    err = max(_err(g_, w_, f"flash_attn_bwd_fused v1 G out{i}", own_scale=True)
              for i, (g_, w_) in enumerate(zip(got, want)))
    del got, want
    repeat = _repeat(lambda: A.flash_backward_fused(*args), "flash_attn_bwd_fused v1 G")
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, scale=inv)
    bound_ms, bound_by = _bound(2.0 * 5 * b * h * n * n * dh, 8 * elem + b * h * n * 4)
    bwd = lambda: A.flash_backward_fused(*args)  # noqa: E731
    out["flash_attn_bwd_fused"] = _with_device_ms(
        {"shape": list(V1_G_SHAPE), "scale": scale, "max_abs_err": err,
         "repeat_max_abs_diff": repeat, "ms": _time_ms(bwd, iters),
         "plain_ms": _time_ms(lambda: A.flash_bwd_fused_reference(*args), 3),
         "bound_ms": bound_ms, "bound_by": bound_by,
         "library_ms": _time_ms(lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), do,
                                                            retain_graph=True), iters)},
        bwd, iters, "flash_attn_bwd_fused")
    for name, r in out.items():
        print(f"  {name} v1 G: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}; on "
              f"the device {r['device_ms']} ms in its kernels, {r['other_device_ms']} ms in the "
              "wrapper's other work)")
    return out


# Kernel launches per v1 train step at the reference defaults under
# runtime.use_pallas=always: G's 4 blocks (`dot`, 32 tokens: single-pass
# backward in the G update), D's 4 blocks (`l2`, 50 tokens: two-pass backward
# under bwd_fusion=auto) on [real; fake] in the D update and on fake in the
# G update; with bwd_fusion=fused D's backward takes the `l2` single pass.
V1_KERNELS = {
    "auto": {"flash_attn_fwd": 4, "flash_attn_fwd[l2]": 8, "flash_attn_bwd_dq[l2]": 8,
             "flash_attn_bwd_dkv[l2]": 8, "flash_attn_bwd_fused": 4},
    "fused": {"flash_attn_fwd": 4, "flash_attn_fwd[l2]": 8, "flash_attn_bwd_fused[l2]": 8,
              "flash_attn_bwd_fused": 4},
}


class _PlainAttentionCounter:
    """Counts calls of the plain attention routes of ops/attention while
    active (dispatch_attention reads them from the module at call time)."""

    NAMES = ("attention_reference", "attention_chunked")

    def __enter__(self):
        from vitgan_tpu_torch.ops import attention as A

        self.calls, self.saved = 0, {n: getattr(A, n) for n in self.NAMES}

        def wrap(fn):
            def counted(*a, **k):
                self.calls += 1
                return fn(*a, **k)
            return counted

        for n, fn in self.saved.items():
            setattr(A, n, wrap(fn))
        return self

    def __exit__(self, *exc):
        from vitgan_tpu_torch.ops import attention as A

        for n, fn in self.saved.items():
            setattr(A, n, fn)


def _v1_cfg(**over):
    from vitgan_tpu_torch import config as C

    base = {"data.dataset": "synthetic", "data.synthetic_samples": 1024, "run.epochs": 1,
            "run.log_every_steps": 0, "runtime.use_pallas": "always"}
    return C.replace(C.ExperimentConfig(family="v1"), **{**base, **over})


def train_v1_main_path(run_dir: str) -> tuple:
    """[train v1 captured]: the v1 ViTGAN at the reference defaults through
    Trainer.fit on the device-data route under use_pallas=always, on 3,072
    samples (24 steps an epoch): 2 eager warm-up steps, 5 eager steps timed,
    a warm-up epoch (the capture), then a timed epoch of captured steps; the
    launches per step held to eager's with no plain attention (counted over
    the capture and the timed epoch), a profiled breakdown of a captured call;
    the run directory restored, one `cli generate` and one HTTP request."""
    import numpy as np
    import torch

    from vitgan_tpu_torch import cli
    from vitgan_tpu_torch.models import count_params
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.serve import serve
    from vitgan_tpu_torch.train.step import host_metrics
    from vitgan_tpu_torch.train.trainer import Trainer
    from vitgan_tpu_torch.utils.run_dirs import restore_run

    tag = "[train v1 captured]"
    eager_steps = 5
    cfg = _v1_cfg(**_fit_over({"data.synthetic_samples": 3072, "run.epochs": 2}))
    m = cfg.v1
    t0 = time.perf_counter()
    trainer = Trainer(cfg, run_dir=run_dir, device="cuda")
    st = trainer.state
    steps = trainer.steps_per_call
    g, d = m.generator, m.discriminator
    print(f"{tag} v1 defaults: batch {m.batch_size}, latent {m.latent_dim}; G hidden "
          f"{g.hidden_size} depth {g.depth} heads {g.transformer.num_heads}, SIREN "
          f"{g.siren_hidden}; D patches {d.patch_size}+2*{d.overlap}, depth {d.depth}, heads "
          f"{d.transformer.num_heads}, ISR {d.spectral_rescale}; loss {m.loss}, "
          f"{cfg.runtime.compute_dtype}, use_pallas {cfg.runtime.use_pallas}, bwd_fusion "
          f"{cfg.runtime.bwd_fusion}; G {count_params(st.g)} D {count_params(st.d)} parameters; "
          f"{steps} steps a call; set up in {time.perf_counter() - t0:.1f} s")
    if steps < 20:
        raise AssertionError(f"{tag} {steps} steps an epoch, fewer than 20")
    before = [p.detach().cpu().clone() for p in (*st.g.parameters(), *st.d.parameters())]
    u0 = [b_.detach().cpu().clone() for n_, b_ in st.d.named_buffers() if n_.endswith(".u")]
    t0 = time.perf_counter()
    for idx in trainer.batches()[:2]:  # warm-up
        warm = host_metrics(trainer.train_step(st, trainer.real_batch(idx)))
    print(f"{tag} 2 warm-up steps in {time.perf_counter() - t0:.2f} s: {warm}")
    eager_ms = _eager_step_ms(trainer, eager_steps)
    grid = _grid_launches(trainer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()  # the capture's allocations count, the replays' none
    with _PlainAttentionCounter() as plain:
        t0 = time.perf_counter()
        trainer.fit(epochs=1)  # the warm-up epoch: its first step runs eagerly, then is captured
        print(f"{tag} warm-up epoch ({steps} steps, the capture among them) in "
              f"{time.perf_counter() - t0:.2f} s")
        _settle()
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        # --- the v1 path ---
        means = trainer.fit()
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        # --- end of the v1 path ---
    sec = time.perf_counter() - t0
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    img_s = means["images_per_sec"]
    ms = 1e3 * m.batch_size / img_s
    print(f"{tag} {steps} captured steps by Trainer.fit: {ms:.3f} ms/step, {img_s:.1f} img/s "
          f"({sec:.3f} s with the checkpoint and the run directory's write), peak "
          f"{peak / 2**30:.3f} GiB allocated ({reserved / 2**30:.3f} reserved) over the capture "
          f"and both epochs; the eager step in this call {eager_ms:.3f} ms ({eager_steps} steps)")
    print(f"{tag} epoch means: {means}")
    print(f"{tag} launches over {steps} steps and the epilogue's grid: {launches}; the grid's "
          f"alone: {grid}; plain attention calls over the capture and the timed epoch "
          f"{plain.calls}")
    launches = _check_fit_launches(tag, launches, V1_KERNELS["auto"], steps, grid)
    per_step = {k: v / steps for k, v in launches.items() if v}
    print(f"{tag} launches per step: {per_step} (eager's: {V1_KERNELS['auto']})")
    if plain.calls:
        raise AssertionError(f"{tag} {plain.calls} attentions took a plain route")
    if not all(math.isfinite(means[k]) for k in ("d_loss", "g_loss", "d_grad_norm",
                                                 "g_grad_norm")):
        raise AssertionError(f"non-finite train metrics: {means}")
    after = [p.detach().cpu() for p in (*st.g.parameters(), *st.d.parameters())]
    moved = sum(not torch.equal(a, b_) for a, b_ in zip(before, after))
    u1 = [b_.detach().cpu() for n_, b_ in st.d.named_buffers() if n_.endswith(".u")]
    u_moved = sum(not torch.equal(a, b_) for a, b_ in zip(u0, u1))
    print(f"{tag} {moved} of {len(after)} parameter tensors and {u_moved} of {len(u1)} ISR u "
          "buffers moved")
    if moved != len(after) or u_moved != len(u1):
        raise AssertionError("some parameters or ISR buffers did not move")
    del before, after
    breakdown = train_breakdown(trainer, ms, recompute=False)
    del trainer, st
    torch.cuda.empty_cache()
    rcfg, _, gen_, meta = restore_run(run_dir, device="cuda")
    if meta.get("step") != 2 + eager_steps + 2 * steps or rcfg.v1 != m or rcfg.family != "v1":
        raise AssertionError(f"restored run: meta {meta}")
    del gen_
    if cli.main(["generate", "--run-dir", run_dir, "--num-images", "16", "--seed", "3"]) != 0:
        raise AssertionError("cli generate failed")
    z = np.load(os.path.join(run_dir, "test", "noise.npy"))
    with open(os.path.join(run_dir, "test", "generated_images.png"), "rb") as f:
        h, w = _png_shape(f.read())
    if z.shape != (16, m.latent_dim) or (h, w) != (4 * 34 + 2, 4 * 34 + 2):
        raise AssertionError(f"cli generate wrote {z.shape} latents, a {h}x{w} grid")
    print(f"{tag} restored step {meta['step']} and `cli generate` wrote a {h}x{w} grid")
    httpd = serve(run_dir, host="127.0.0.1", port=0, batch=64)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        status, _, body, req_ms = _post(f"http://127.0.0.1:{httpd.server_address[1]}",
                                        {"n": 16, "seed": 1, "format": "npy"})
    finally:
        httpd.shutdown()
        httpd.server_close()
    arr = np.load(io.BytesIO(body))
    if status != 200 or arr.shape != (16, 32, 32, 3) or not np.isfinite(arr).all() \
            or arr.std() < 1e-3:
        raise AssertionError(f"serving the v1 run directory: {status} {arr.shape}")
    print(f"{tag} the v1 run directory served POST npy n=16 in {req_ms:.1f} ms "
          f"(std {arr.std():.4f})")
    return launches, {"ms_per_step": ms, "eager_ms_per_step": eager_ms, "img_per_s": img_s,
                      "steps": steps, "peak_allocated_bytes": peak,
                      "peak_reserved_bytes": reserved, "means": means, "breakdown": breakdown}


def train_v1_fused(steps: int = 3) -> tuple:
    """The v1 defaults under use_pallas=always and bwd_fusion=fused through
    Trainer: 1 eager warm-up step, a warm-up epoch of ``steps`` (the
    capture), then ``steps`` captured by fit; D's `l2` backward takes the
    single-pass kernel (8 a step), no dq or dk/dv; then a profiled breakdown
    of a captured call."""
    import tempfile

    import torch

    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.train.step import host_metrics
    from vitgan_tpu_torch.train.trainer import Trainer

    cfg = _v1_cfg(**_fit_over({"run.steps_per_epoch": steps, "run.epochs": 2,
                               "runtime.bwd_fusion": "fused"}))
    run_dir = tempfile.mkdtemp(prefix="v1_fused_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    metrics = None
    try:
        trainer = Trainer(cfg, run_dir=run_dir, device="cuda")
        metrics = trainer.metrics
        host_metrics(trainer.train_step(trainer.state, trainer.real_batch(trainer.batches()[0])))
        grid = _grid_launches(trainer)
        trainer.fit(epochs=1)
        _settle()
        torch.cuda.synchronize()
        build.reset_launches()
        # --- the v1 bwd_fusion=fused path ---
        means = trainer.fit()
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        # --- end of the v1 bwd_fusion=fused path ---
        ms = 1e3 * cfg.v1.batch_size / means["images_per_sec"]
        breakdown = train_breakdown(trainer, ms, recompute=False)
    finally:
        _remove_run_dir(run_dir, metrics)
    print(f"[train v1 fused] {steps} captured steps by Trainer.fit, {ms:.2f} ms/step; launches "
          f"{launches}; means {means}")
    launches = _check_fit_launches("[train v1 fused]", launches, V1_KERNELS["fused"], steps, grid)
    if not all(math.isfinite(means[k]) for k in ("d_loss", "g_loss")):
        raise AssertionError(f"[train v1 fused] non-finite metrics: {means}")
    return launches, {"ms_per_step": ms, "means": means, "breakdown": breakdown}


def _flat_state(st) -> dict:
    """Every tensor of a TrainState's checkpoint dict by a dotted name (on
    the CPU), plus its host counters."""
    import torch

    sd = st.state_dict()
    out = {"step": torch.tensor(sd["step"]), "rng": sd["rng"]}
    for net in ("g", "d"):
        out.update({f"{net}.{k}": v for k, v in sd[net].items()})
        opt = sd[f"{net}_opt"]
        out[f"{net}_opt.count"] = torch.tensor(opt["count"])
        if "mini_step" in opt:  # grad_accum: the accumulator and its mini step
            out[f"{net}_opt.mini_step"] = torch.tensor(opt["mini_step"])
            out.update({f"{net}_opt.acc.{i}": a for i, a in enumerate(opt["acc"])})
        for i, entry in opt["state"].items():
            out.update({f"{net}_opt.{i}.{k}": v for k, v in entry.items()})
    for i, e in enumerate(sd["g_ema"] or ()):
        out[f"g_ema.{i}"] = e
    return out


def _leaf_group(name: str) -> str:
    if name.startswith(("g_opt.", "d_opt.")):
        return f"{name[0].upper()} optimizer state"
    if name.startswith("g_ema."):
        return "G EMA"
    if name.startswith("d.") and name.endswith((".u", ".sigma0")):
        return "D ISR buffers"
    if name.startswith(("g.", "d.")):
        return f"{name[0].upper()} parameters"
    return "counters and generator state"


def _hold_states(tag: str, start: dict, want: dict, got: dict) -> dict:
    """``got`` against ``want`` after the same steps from ``start``, leaf by
    leaf in the route comparison's terms: a leaf's change within LEAF_RTOL *
    the max |change| of ``want``'s (a leaf that did not change, the counters
    and the generator state bit-equal), the ISR u vectors within U_TOL.
    Prints and returns max |d| and the bit-equal share per group."""
    import torch

    groups: dict = {}
    for name, w in want.items():
        # a leaf the start lacks (optimizer state the steps created) starts at 0
        g_, s0 = got[name], start.get(name, torch.zeros_like(w))
        grp = _leaf_group(name)
        rec = groups.setdefault(grp, {"leaves": 0, "bit_equal": 0, "max_abs_diff": 0.0})
        rec["leaves"] += 1
        if torch.equal(g_, w):
            rec["bit_equal"] += 1
            continue
        if not w.is_floating_point() or grp == "counters and generator state":
            raise AssertionError(f"{tag} {name} differs: {w} against {g_}")
        d = (g_.double() - w.double()).abs().max().item()
        rec["max_abs_diff"] = max(rec["max_abs_diff"], d)
        if name.endswith(".u"):
            bound = U_TOL
        else:
            bound = LEAF_RTOL * (w.double() - s0.double()).abs().max().item()
        if not d <= bound:
            raise AssertionError(f"{tag} {name}: max |d| {d:.3e} over its bound {bound:.3e}")
    for grp, rec in groups.items():
        print(f"{tag}   {grp}: {rec['bit_equal']} of {rec['leaves']} leaves bit-equal, max |d| "
              f"{rec['max_abs_diff']:.3e}")
    return groups


def captured_vs_eager(cfg, n: int, label: str, trainer=None) -> dict:
    """[captured vs eager]: from one state (after one eager step, so that the
    optimizer's state exists), one batch order, one latent block and one
    generator state, ``n`` steps of a captured make_device_data_train_fn
    against ``n`` eager make_train_step calls; the function is captured
    first on the same state, which is then restored in place (the
    checkpoint's restore), so that all n of its steps are replays.  Every
    leaf in the route comparison's terms; metrics: losses within LOSS_TOL,
    norms within NORM_RTOL.  ``trainer``: one already built for ``cfg`` (its
    state goes on from where it is)."""
    import tempfile

    import numpy as np
    import torch

    from vitgan_tpu_torch.train.sample import latent_block
    from vitgan_tpu_torch.train.step import host_metrics, make_device_data_train_fn
    from vitgan_tpu_torch.train.trainer import Trainer

    tag = f"[captured vs eager] {label}"
    run_dir = tempfile.mkdtemp(prefix="cve_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    metrics = None  # a Trainer of this phase's own writes into run_dir
    try:
        if trainer is None:
            trainer = Trainer(cfg, run_dir=run_dir, device="cuda")
            metrics = trainer.metrics
        st, gan, b = trainer.state, trainer.gan, cfg.model.batch_size
        order = trainer.batches()
        host_metrics(trainer.train_step(st, trainer.real_batch(order[0])))
        idx = order[1:1 + n]
        fn = make_device_data_train_fn(gan, cfg, n)
        lat = latent_block(gan, st.seed, st.step, n, b,
                           max(1, getattr(cfg.model, "disc_steps", 1)))
        start_sd = st.state_dict()
        start = _flat_state(st)
        fn(st, trainer.dataset, idx, lat)  # the first step eager, its capture, n - 1 replays
        st.load_state_dict(start_sd)
        eager_m = [trainer.train_step(st, trainer.real_batch(idx[i]), z=torch.from_numpy(
            lat[i, 0])) for i in range(n)]
        eager_m = {k: torch.stack([m_[k] for m_ in eager_m]) for k in eager_m[0]}
        want = _flat_state(st)
        st.load_state_dict(start_sd)
        got_m = fn(st, trainer.dataset, idx, lat)  # n replays
        got = _flat_state(st)
        print(f"{tag}: {n} steps at batch {b}, {len(fn.graphs)} captured graph(s)")
        groups = _hold_states(tag, start, want, got)
        hm_w = {k: np.asarray(v.cpu()) for k, v in eager_m.items()}
        hm_g = {k: np.asarray(v.cpu()) for k, v in got_m.items()}
        metric_diff = {}
        for k in hm_w:
            d = float(np.abs(hm_w[k] - hm_g[k]).max())
            metric_diff[k] = d
            bound = (NORM_RTOL * float(np.abs(hm_w[k]).max()) if k.endswith("grad_norm")
                     else LOSS_TOL)
            if not d <= bound:
                raise AssertionError(f"{tag} metric {k}: {hm_g[k]} against eager {hm_w[k]}")
        bit_equal = all(r["bit_equal"] == r["leaves"] for r in groups.values()) and not any(
            metric_diff.values())
        print(f"{tag}: metrics max |d| {metric_diff}; the routes are "
              f"{'bit-equal' if bit_equal else 'NOT bit-equal'}")
        del trainer, st, fn
        torch.cuda.empty_cache()
    finally:
        _remove_run_dir(run_dir, metrics)
    return {"n": n, "groups": groups, "metric_max_abs_diff": metric_diff, "bit_equal": bit_equal}


def resume_check() -> dict:
    """[resume]: v1 at its reference defaults under use_pallas=always, 2
    steps an epoch: 2 epochs uninterrupted, twice; then 1 epoch, its final
    checkpoint, a fresh Trainer's resume() and the second epoch.  Where the
    two uninterrupted runs are bit-equal the resumed one must be too; else
    every leaf within their spread."""
    import shutil as _sh
    import tempfile

    import torch

    from vitgan_tpu_torch.train.trainer import Trainer

    cfg = _v1_cfg(**_fit_over({"run.steps_per_epoch": 2, "run.epochs": 2}))
    base = tempfile.mkdtemp(prefix="resume_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))

    def run(name: str, epochs: int, resume: bool = False) -> dict:
        trainer = Trainer(cfg, run_dir=os.path.join(base, name), device="cuda")
        if resume:
            trainer.resume()
        trainer.fit(epochs=epochs)
        out = _flat_state(trainer.state)
        trainer.metrics.close()  # its writer thread, before the run directory goes
        del trainer
        torch.cuda.empty_cache()
        return out

    try:
        a1, a2 = run("a1", 2), run("a2", 2)
        run("b", 1)
        c = run("b", 2, resume=True)
        cli_steps = _cli_resume(os.path.join(base, "cli"))
    finally:
        _sh.rmtree(base, ignore_errors=True)
    same = all(torch.equal(a1[k], a2[k]) for k in a1)
    spread = {k: (a2[k].double() - a1[k].double()).abs().max().item()
              for k in a1 if a1[k].is_floating_point()}
    worst, bit_equal = 0.0, True
    for k in a1:
        if torch.equal(c[k], a1[k]):
            continue
        bit_equal = False
        if same or not a1[k].is_floating_point():
            raise AssertionError(f"[resume] {k} differs from the uninterrupted runs, which are "
                                 "bit-equal to each other")
        d = min((c[k].double() - a1[k].double()).abs().max().item(),
                (c[k].double() - a2[k].double()).abs().max().item())
        worst = max(worst, d)
        if not d <= spread[k]:
            raise AssertionError(f"[resume] {k}: max |d| {d:.3e} over the spread {spread[k]:.3e}")
    print(f"[resume] v1, 2 + 2 captured steps across a checkpoint and a fresh Trainer's "
          f"resume(): the uninterrupted runs {'bit-equal' if same else 'not bit-equal'} to "
          f"each other; the resumed run {'bit-equal to them' if bit_equal else f'within their spread (max |d| {worst:.3e})'} "
          f"over {len(a1)} leaves")
    return {"uninterrupted_bit_equal": same, "resumed_bit_equal": bit_equal,
            "max_abs_diff": worst, "leaves": len(a1), "cli_resume_steps": cli_steps}


def _cli_resume(run_dir: str) -> list:
    """`cli train` of v1 (use_pallas=always, 2 steps an epoch) for one
    epoch, then `cli train --resume --epochs 2` on its run directory: the
    latest checkpoint and the served generator must move on to step 4."""
    import torch

    from vitgan_tpu_torch import cli
    from vitgan_tpu_torch.utils.checkpoint import CheckpointManager
    from vitgan_tpu_torch.utils.run_dirs import restore_run

    args = ["train", "--family", "v1", "--dataset", "synthetic", "--run-dir", run_dir]
    for kv in ("data.synthetic_samples=1024", "run.steps_per_epoch=2",
               "runtime.use_pallas=always", "run.sample_grid_every_epochs=0",
               "run.fid_every_epochs=0", "run.log_every_steps=0"):
        args += ["--set", kv]
    steps = []
    for extra in (["--epochs", "1"], ["--epochs", "2", "--resume"]):
        if cli.main(args + extra) != 0:
            raise AssertionError(f"cli train {' '.join(extra)} failed")
        _, meta = CheckpointManager(os.path.join(run_dir, "checkpoints")).restore()
        steps.append((meta["step"], meta["epoch"]))
        torch.cuda.empty_cache()
    _, _, _, served = restore_run(run_dir, device="cuda")
    if steps != [(2, 1), (4, 2)] or served.get("step") != 4:
        raise AssertionError(f"cli train --resume: checkpoints {steps}, run directory {served}")
    print(f"[resume] `cli train` then `cli train --resume` on the card: checkpoints at "
          f"(step, next epoch) {steps}")
    return steps


def optimizer_update() -> dict:
    """[optimizer]: one update of the port's Optimizer (global norm, clip,
    AdamW at the device rate) over highres128's G and D parameter shapes
    (144.6 M f32), with torch.optim's fused and foreach forms in turns
    (fused, foreach, foreach, fused), CUDA events over 10 updates after 2;
    bound: 28 bytes a parameter (p, g, m, v read; p, m, v written)."""
    import torch

    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.models import build_gan
    from vitgan_tpu_torch.train import state as S

    cfg = C.highres_config(128)
    gan = build_gan(cfg)
    with torch.device("meta"):
        shapes = [p.shape for net in (gan.generator_init(None, device="meta"),
                                      gan.discriminator_init(None, device="meta"))
                  for p in net.parameters()]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = [torch.nn.Parameter(0.02 * torch.randn(sh, generator=gen, device="cuda"))
              for sh in shapes]
    for p in params:
        p.grad = 0.01 * torch.randn(p.shape, generator=gen, device="cuda")
    n = sum(p.numel() for p in params)
    bound = 28 * n / HBM_BYTES_PER_S * 1e3
    saved, out = S.FUSED_ON_CUDA, {}
    try:
        for fused in (True, False, False, True):
            S.FUSED_ON_CUDA = fused
            opt = S.Optimizer(cfg.v2.gen_optim, params)
            ms = _time_ms(lambda: opt.update(1e-4), 10)
            out.setdefault("fused" if fused else "foreach", []).append(ms)
            del opt
    finally:
        S.FUSED_ON_CUDA = saved
    print(f"[optimizer] one update (norm, clip, AdamW) of {n} parameters: fused "
          f"{out['fused']} ms, foreach {out['foreach']} ms; bound {bound:.3f} ms (bytes)")
    del params
    torch.cuda.empty_cache()
    return {"parameters": n, "ms": out, "bound_ms": bound, "port_uses_fused": saved}


class _ScalarTerms:
    """While active on a v1 train state, sums each scalar gradient leaf's
    per-sample terms, the scale of the sum that the leaf is: G's SLN gamma
    and beta (gamma * w * LN(h) + beta * w, layers.sln) sum dy * w * LN(h)
    and dy * w over each sample's tokens and features; D's head bias sums
    dlogit over the rows of the D update's [real; fake] forward.  At dropout
    0 neither network couples samples (no batch statistics; the ISR state
    depends on D's weights alone), so these are the terms of the gradient's
    sum over samples.  ``abs[name]`` is sum_i |term_i|, ``signed[name]``
    sum_i term_i, which must equal the gradient."""

    def __init__(self, state):
        self.g, self.d = state.g, state.d

    def __enter__(self):
        import torch

        from vitgan_tpu_torch.models import layers as L

        self.abs, self.signed, self.sln = {}, {}, L.sln
        names = {id(p): f"g.{n}" for n, p in self.g.named_parameters()}

        def add(name, per_sample):
            self.abs[name] = self.abs.get(name, 0.0) + per_sample.abs().sum().item()
            self.signed[name] = self.signed.get(name, 0.0) + per_sample.sum().item()

        def sln(p, h, w):
            y = self.sln(p, h, w)
            if y.requires_grad:
                def terms(dy):
                    with torch.no_grad():
                        add(names[id(p.beta)], (dy * w).flatten(1).sum(1))
                        add(names[id(p.gamma)],
                            (dy * w * L.layer_norm(p.ln, h)).flatten(1).sum(1))
                y.register_hook(terms)
            return y

        def logits(module, args, kwargs, y):
            if kwargs.get("update_state") and y.requires_grad:
                y.register_hook(lambda dy: add("d.head.b", dy))

        L.sln = sln
        self.handle = self.d.register_forward_hook(logits, with_kwargs=True)
        return self

    def __exit__(self, *exc):
        from vitgan_tpu_torch.models import layers as L

        L.sln = self.sln
        self.handle.remove()


def _flash_bwd_f32_ds(q, k, v, o, lse, do, scale: float, delta=None, score_mode: str = "dot"):
    """The flash backward's plain version with dS kept in f32 before its
    products, as autograd through the plain attention keeps it (the kernels
    and flash_bwd_fused_reference round it to bf16); P is rounded for dV as
    both do."""
    import torch

    from vitgan_tpu_torch.ops import attention as A

    p, ds = A._bwd_terms(q, k, v, o, lse, do, scale, delta, score_mode)
    dq = A._score_grad(torch.einsum("bhnm,bhmd->bhnd", ds, k.float()), ds, q, scale, score_mode,
                       -1)
    dk = A._score_grad(torch.einsum("bhnm,bhnd->bhmd", ds, q.float()), ds, k, scale, score_mode,
                       -2)
    dv = torch.einsum("bhnm,bhnd->bhmd", p.to(q.dtype).float(), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bf16_flash_forward(kernel_fwd):
    """The flash forward of the f32 route control: the bf16 kernel on q, k, v
    rounded to bf16, o returned in the inputs' dtype."""
    def forward(q, k, v, scale, out=None, score_mode="dot"):
        o, lse = kernel_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), scale, out=out,
                            score_mode=score_mode)
        return o.to(q.dtype), lse
    return forward


def _bf16_flash_backward(kernel_bwd):
    """The flash backward of the f32 route control: the bf16 kernels (on the
    bf16 route) on q, k, v, o, dO rounded to bf16, gradients returned in the
    inputs' dtype."""
    def backward(q, k, v, o, lse, do, scale, delta=None, score_mode="dot"):
        grads = kernel_bwd(*(t.bfloat16() for t in (q, k, v, o)), lse, do.bfloat16(), scale,
                           delta, score_mode)
        return tuple(g.to(q.dtype) for g in grads)
    return backward


def compare_v1_train_routes(batch: int = 8, diagnose: bool = False,
                            dtype: str = "bfloat16") -> dict:
    """One v1 step at the reference widths, dropout 0, from the same state,
    batch and latents on use_pallas=always with bwd_fusion auto (D's `l2`
    two-pass) and fused, and on use_pallas=never; each kernel route (in
    ``dtype``) held to the plain route in f32, the ISR u buffers included,
    and (bf16) the bf16 plain route's own distance printed beside.  Under
    use_pallas=auto the step launches no kernel.  In f32 the kernel routes
    also take bwd_fusion=two_pass (G's `dot` backward then runs dq and dk/dv)
    and are held to the F32_ bounds, which the bf16-flash control
    F32_CONTROL must miss; each route's launches are returned beside its
    distances.

    Losses, gradient norms and every leaf of more than one element are held
    as v2's are: max|d| within LEAF_RTOL (f32: F32_LEAF_RTOL) of the leaf's
    max|plain|.  A scalar
    leaf (G's 18 SLN gammas and betas, D's head bias) is one sum over the
    batch's samples, and some of G's cancel to 1e-5 beside terms of 1e-4:
    its |d| is held within LEAF_RTOL of the sum of its per-sample terms'
    magnitudes in the f32 route (_ScalarTerms), the scale of what it sums as
    max|plain| is of a wider leaf.

    With ``diagnose`` two more routes run the flash forward kernels with the
    backward's plain versions on the card: dS rounded to bf16 before its
    products (as the kernels round it) and dS in f32 (as autograd through the
    plain attention keeps it); reported beside the others, not held."""
    import statistics

    import torch

    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.data.datasets import synthetic_dataset
    from vitgan_tpu_torch.models import build_gan
    from vitgan_tpu_torch.ops import attention as A
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.ops.policy import apply_from_runtime, get_policy, set_policy
    from vitgan_tpu_torch.train.sample import latent_rng
    from vitgan_tpu_torch.train.state import create_train_state
    from vitgan_tpu_torch.train.step import host_metrics, make_train_step

    drop = {f"v1.{net}.transformer.{k}": 0.0 for net in ("generator", "discriminator")
            for k in ("attn_dropout", "mlp_dropout")}
    cfg = _v1_cfg(**{"v1.batch_size": batch, **drop})
    gan = build_gan(cfg)
    images, _ = synthetic_dataset(batch, 32, 3, seed=SEED)
    real = torch.from_numpy(images).cuda().float() * (2.0 / 255.0) - 1.0
    z = gan.sample_latent(latent_rng(SEED, 0), batch)
    saved, kernel_fwd, kernel_bwd = get_policy(), A.flash_forward, A.flash_backward
    always, fused = dict(mode="always", bwd_fusion="auto"), dict(mode="always", bwd_fusion="fused")
    plain = dict(mode="never", bwd_fusion="auto")
    kernel_dtype = getattr(torch, dtype)
    if dtype == "float32":
        loss_tol, norm_rtol, leaf_rtol = F32_LOSS_TOL, F32_NORM_RTOL, F32_LEAF_RTOL
        routes = [("always", always, dtype, None), ("always_fused", fused, dtype, None),
                  ("always_two_pass", dict(mode="always", bwd_fusion="two_pass"), dtype, None),
                  (F32_CONTROL, always, dtype, _bf16_flash_backward(kernel_bwd)),
                  ("plain_f32", plain, "float32", None)]
    else:
        loss_tol, norm_rtol, leaf_rtol = LOSS_TOL, NORM_RTOL, LEAF_RTOL
        routes = [("always", always, "bfloat16", None), ("always_fused", fused, "bfloat16", None),
                  ("plain", plain, "bfloat16", None), ("plain_f32", plain, "float32", None),
                  ("auto", dict(mode="auto", bwd_fusion="auto"), "bfloat16", None)]
    if diagnose:
        routes += [("plain_bwd_bf16_dS", always, "bfloat16", A.flash_bwd_fused_reference),
                   ("plain_bwd_f32_dS", always, "bfloat16", _flash_bwd_f32_ds)]
    res, launches = {}, {}
    try:
        apply_from_runtime(cfg.runtime)
        for route, policy, route_dtype, backward in routes:
            set_policy(**policy)
            A.flash_forward = (_bf16_flash_forward(kernel_fwd) if route == F32_CONTROL
                               else kernel_fwd)
            A.flash_backward = backward or kernel_bwd
            rcfg = C.replace(cfg, **{"runtime.compute_dtype": route_dtype})
            state = create_train_state(gan, rcfg, device="cuda")
            step = make_train_step(gan, rcfg)
            build.reset_launches()
            if route == "plain_f32":
                with _ScalarTerms(state) as terms:
                    metrics = host_metrics(step(state, real, z=z))
            else:
                metrics = host_metrics(step(state, real, z=z))
            launched = {k: n for k, n in build.LAUNCHES.items() if n}
            launches[route] = launched
            print(f"[v1 routes] {route} ({route_dtype}): launches {launched}, metrics {metrics}")
            res[route] = (metrics,
                          [p.grad.float() for p in (*state.g.parameters(), *state.d.parameters())],
                          [f"g.{n}" for n, _ in state.g.named_parameters()]
                          + [f"d.{n}" for n, _ in state.d.named_parameters()],
                          {n: b.float() for n, b in state.d.named_buffers() if n.endswith(".u")})
            if policy["mode"] != "always" and launched:
                raise AssertionError(f"the v1 step on use_pallas={policy['mode']} launched "
                                     f"{launched}")
            l2_bwd = A.launch_key("flash_attn_bwd_fused" if route == "always_fused"
                                  else "flash_attn_bwd_dq", "l2", kernel_dtype)
            if backward is None and policy["mode"] == "always" and build.LAUNCHES[l2_bwd] != 8:
                raise AssertionError(f"{route}: {l2_bwd} did not run in every D block")
            if policy["mode"] == "always" and route != F32_CONTROL and any(
                    (k.startswith("flash_attn") and "_f32[" in k) != (dtype == "float32")
                    for k in launched):
                raise AssertionError(f"{route}: a flash kernel of another dtype than {dtype} "
                                     f"launched: {launched}")
            del state, step
            torch.cuda.empty_cache()
    finally:
        set_policy(**saved)
        A.flash_forward, A.flash_backward = kernel_fwd, kernel_bwd
    mp, gp, names, up = res["plain_f32"]
    scalars = [i for i, b in enumerate(gp) if b.numel() == 1]
    for i in scalars:
        name = names[i]
        if name not in terms.abs:
            raise AssertionError(f"no per-sample terms recorded for the scalar leaf {name}")
        if not abs(terms.signed[name] - gp[i].item()) <= 1e-3 * terms.abs[name]:
            raise AssertionError(f"{name}: its per-sample terms sum to {terms.signed[name]:.6g}, "
                                 f"its gradient is {gp[i].item():.6g}")
    cancel = names[min(scalars, key=lambda i: abs(gp[i].item()) / terms.abs[names[i]])]
    print(f"[v1 routes] batch {batch}: {len(scalars)} scalar leaves; the most cancelled, "
          f"{cancel}: f32 gradient {gp[names.index(cancel)].item():.3g}, sum of |per-sample "
          f"terms| {terms.abs[cancel]:.3g}")
    out, by_route, failed = {}, {}, []
    compared = [r for r, *_ in routes if r not in ("plain_f32", "auto")]
    for route in compared:
        mk, gk, _, uk = res[route]
        r = out[route] = {"launches": launches[route]}
        checked = route.startswith("always")  # the others are reported, not held
        misses = []  # the bounds this route misses
        for key in ("d_loss", "g_loss"):
            r[key] = abs(mk[key] - mp[key])
            print(f"[v1 routes] {route} {key}: {mk[key]:.6f}, plain f32 {mp[key]:.6f} "
                  f"(|d| {r[key]:.3g}, tolerance {loss_tol})")
            if not r[key] <= loss_tol:
                misses.append(key)
        for key in ("d_grad_norm", "g_grad_norm"):
            r[key] = abs(mk[key] - mp[key]) / mp[key]
            print(f"[v1 routes] {route} {key}: {mk[key]:.6f}, plain f32 {mp[key]:.6f} "
                  f"(relative {r[key]:.3g}, tolerance {norm_rtol})")
            if not r[key] <= norm_rtol:
                misses.append(key)
        wide, by_terms, alone = {}, {}, {}
        for name, a, b in zip(names, gk, gp):
            d = (a - b).abs().max().item()
            d = d if math.isfinite(d) else math.inf
            if b.numel() == 1:
                by_terms[name] = d / max(terms.abs[name], 1e-30)
                alone[name] = d / max(abs(b.item()), 1e-30)
            else:
                wide[name] = d / max(b.abs().max().item(), 1e-30)
        worst, worst_s = max(wide, key=wide.get), max(by_terms, key=by_terms.get)
        by_route[route] = by_terms
        r.update({"worst_leaf_rel": wide[worst], "worst_leaf": worst,
                  "worst_scalar_rel_terms": by_terms[worst_s], "worst_scalar": worst_s,
                  "median_scalar_rel_terms": statistics.median(by_terms.values()),
                  "worst_scalar_alone_rel": max(alone.values())})
        print(f"[v1 routes] {route}: {len(wide)} gradient leaves of more than one element, worst "
              f"max|d| / max|plain f32| {wide[worst]:.4g} at {worst}; {len(by_terms)} scalar "
              f"leaves, worst |d| / sum of |per-sample terms| {by_terms[worst_s]:.4g} at "
              f"{worst_s} (median {r['median_scalar_rel_terms']:.4g}; tolerance {leaf_rtol}"
              f"{'' if checked else '; reported, not held'}); a scalar alone at most "
              f"{r['worst_scalar_alone_rel']:.4g} of itself")
        if not (wide[worst] <= leaf_rtol and by_terms[worst_s] <= leaf_rtol):
            misses.append("a gradient leaf")
        r["misses"] = misses
        if route == F32_CONTROL:
            print(f"[v1 routes] {route} misses the f32 bounds on {misses or 'nothing'}")
            if not misses:
                failed.append(f"{route}: the f32 bounds do not see flash kernels that round "
                              "through bf16")
        elif checked and misses:
            failed.append(f"{route}: " + ", ".join(misses) + " differ from the plain route")
        r["isr_u_max_abs"] = max((uk[n] - up[n]).abs().max().item() for n in up)
        print(f"[v1 routes] {route}: {len(up)} ISR u buffers after the step within "
              f"{r['isr_u_max_abs']:.3g} of the plain route's (tolerance {U_TOL})")
        if not r["isr_u_max_abs"] <= U_TOL:
            failed.append(f"{route}: the ISR state differs from the plain route")
    if diagnose:
        print(f"[v1 routes] batch {batch}, per scalar leaf: f32 gradient, sum of |per-sample "
              "terms|; |d| / that sum on " + ", ".join(compared))
        for i in scalars:
            n = names[i]
            print(f"  {n}: {gp[i].item():.4g}, {terms.abs[n]:.4g}; "
                  + ", ".join(f"{by_route[r_][n]:.3g}" for r_ in compared))
    if failed:
        raise AssertionError(f"v1 routes at batch {batch} ({dtype}): " + "; ".join(failed))
    return out


def l2ref_path(dtype: str = "bfloat16") -> dict:
    """The `l2ref` route: an ISR attention of the v1 discriminator's width
    (432, 4 heads of 108) on 256 x 50 tokens in ``dtype`` under
    use_pallas=always, forward and backward.  The forward kernel (the f32
    kernel in f32) launches once; the backward is
    autograd of the plain chunked recompute, as the JAX package's `_bwd`
    (vitgan_tpu/ops/attention.py:861-870): no backward kernel launches.  The
    gradients are held to autograd through the plain attention."""
    import torch

    from vitgan_tpu_torch.models import layers as L
    from vitgan_tpu_torch.ops import attention as A
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.ops.policy import get_policy, set_policy

    msha = L.MHSA(432, 4, torch.Generator().manual_seed(SEED), qkv_bias=False, init="torch",
                  spectral=True).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    dt = getattr(torch, dtype)
    key = A.launch_key("flash_attn_fwd", "l2ref", dt)
    x = torch.randn((256, 50, 432), generator=gen, device="cuda").to(dt)
    g = torch.randn((256, 50, 432), generator=gen, device="cuda").to(dt)
    saved = get_policy()
    grads = {}
    try:
        for route, mode in (("kernel", "always"), ("plain", "never")):
            set_policy(mode=mode)
            xr = x.clone().requires_grad_()
            build.reset_launches()
            # --- the l2ref path (kernel route) ---
            out = L.mhsa(msha, xr, score_mode="l2ref")
            grads[route] = torch.autograd.grad(out, (xr, msha.qkv), g)
            torch.cuda.synchronize()
            launched = {k: n for k, n in build.LAUNCHES.items() if n}
            # --- end of the l2ref path ---
            print(f"[l2ref] {route} ({dtype}): launches {launched}")
            want = {key: 1} if route == "kernel" else {}
            if launched != want:
                raise AssertionError(f"l2ref {route} route launched {launched}, expected {want}")
            if route == "kernel":
                launches = launched[key]
    finally:
        set_policy(**saved)
    worst = max((a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
                for a, b in zip(grads["kernel"], grads["plain"]))
    print(f"[l2ref] dx and dqkv within {worst:.4g} of their max|plain| (tolerance {LEAF_RTOL})")
    if not worst <= LEAF_RTOL:
        raise AssertionError("the l2ref route's gradients differ from the plain route's")
    return {"launches": launches, "worst_grad_rel": worst}


# --- the f32 flash kernels (csrc/flash_f32.cuh, flash_f32_bwd.cuh) ---------------------

PEAK_TF32_FLOPS = 494.7e12  # H100 SXM dense TF32 (NVIDIA data sheet)
# An f32 kernel against its plain version in full f32 (allow_tf32 False): the
# kernels round every product's operands to TF32 (2**-11 relative).  A forward
# output within F32_RTOL * max(1, max|plain|), the LSE within F32_LSE_TOL, a
# backward output within F32_RTOL * its own max|plain|; each at most half the
# bf16 kernel's error on the same inputs (it does not round through bf16).
F32_RTOL, F32_LSE_TOL = 5e-3, 2.5e-3
# (label, (B, H, N, Dh), softmax scale, forward modes, {backward kernel: modes}):
# the v1 generator's and discriminator's attention at the reference defaults,
# the generator of highres128 (single pass), the discriminators of highres128
# and highres256p4 (two-pass in f32) and highres256p4's generator (single
# pass), a ragged N at the v1 head width in every mode, one head of 16,385
# tokens.
F32_SHAPES = (
    ("v1 G", (128, 4, 32, 96), 384.0, ("dot",), {"fused": ("dot",)}),
    ("v1 D", (256, 4, 50, 108), 432.0, ("l2", "l2ref"),
     {"fused": ("l2",), "dq": ("l2",), "dkv": ("l2",)}),
    ("highres128 G", (32, 6, 1024, 64), 64.0, ("dot",), {"fused": ("dot",)}),
    ("highres128 D", (32, 6, 1025, 64), 64.0, ("dot",), {"dq": ("dot",), "dkv": ("dot",)}),
    ("highres256p4 G", (8, 6, 4096, 64), 64.0, ("dot",), {"fused": ("dot",)}),
    ("highres256p4 D", (16, 6, 4097, 64), 64.0, ("dot",), {"dq": ("dot",), "dkv": ("dot",)}),
    ("ragged", (4, 4, 65, 108), 432.0, ("dot", "l2", "l2ref"),
     {kind: ("dot", "l2") for kind in ("fused", "dq", "dkv")}),
    ("long", (1, 1, 16385, 64), 64.0, ("dot",),
     {kind: ("dot",) for kind in ("fused", "dq", "dkv")}),
)
# The shape of each f32 kernel's main record: where its main path runs it.
F32_MAIN = {"flash_attn_fwd_f32[dot]": "v1 G", "flash_attn_fwd_f32[l2]": "v1 D",
            "flash_attn_fwd_f32[l2ref]": "v1 D", "flash_attn_bwd_fused_f32[dot]": "v1 G",
            "flash_attn_bwd_fused_f32[l2]": "v1 D", "flash_attn_bwd_dq_f32[l2]": "v1 D",
            "flash_attn_bwd_dkv_f32[l2]": "v1 D", "flash_attn_bwd_dq_f32[dot]": "highres128 D",
            "flash_attn_bwd_dkv_f32[dot]": "highres128 D"}
# The parts of the f32 kernels' CUDA symbols (the k-block kernel's mma.sync
# name too, for a parent that scripts/kernel_ab.py measures).
F32_SYMBOLS = {"flash_attn_fwd": ("flash_fwd_f32_kernel",),
               "flash_attn_bwd_fused": ("flash_bwd_kv_tf32_kernel", "flash_bwd_kv_f32_kernel"),
               "flash_attn_bwd_dq": ("flash_bwd_dq_f32_kernel",),
               "flash_attn_bwd_dkv": ("flash_bwd_kv_tf32_kernel", "flash_bwd_kv_f32_kernel")}


def _bound_f32(flops: float, nbytes: float):
    """The least time of an f32 kernel: TF32 products against 4-byte operands."""
    t_ops, t_bytes = flops / PEAK_TF32_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _rel_err(got, want, own: bool) -> tuple:
    """(max |got - want|, the bar's scale: max(1, max|want|), or max|want| with
    ``own``), after a sync; raises on a shape mismatch or a non-finite value."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError("non-finite kernel output")
    peak = want.float().abs().max().item()
    return (got.float() - want.float()).abs().max().item(), (peak if own else max(1.0, peak))


def check_f32_kernels() -> dict:
    """[f32 kernels]: the f32 flash kernels at F32_SHAPES against their plain
    versions in full f32 on the same inputs, each held to its bar and to half
    the bf16 kernel's error on the same inputs cast to bf16; each backward
    kernel's outputs bit-equal across two calls, contiguous at the unpadded
    head width; timed (wrapper, device time of its own kernels by the
    profiler and of its other work, the plain version, the bound at TF32,
    scaled_dot_product_attention in f32 where it computes the same function:
    `dot`, and `l2` through its key mask).  Returns {launch key: record}, the
    record at F32_MAIN's shape with the other shapes' errors and times
    beside."""
    import torch
    import torch.nn.functional as F

    from vitgan_tpu_torch.ops import attention as A

    f32 = torch.float32
    bwd = {"fused": ("flash_attn_bwd_fused", A.flash_backward_fused,
                     A.flash_bwd_fused_reference, 5, 3),
           "dq": ("flash_attn_bwd_dq", A.flash_backward_dq, A.flash_bwd_dq_reference, 3, 1),
           "dkv": ("flash_attn_bwd_dkv", A.flash_backward_dkv, A.flash_bwd_dkv_reference, 4, 2)}
    out = {name: {} for name in F32_MAIN}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    for label, shape, scale, fwd_modes, bwd_modes in F32_SHAPES:
        b, h, n, dh = shape
        inv = 1.0 / math.sqrt(scale)
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda") for _ in range(4))
        qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
        print(f"[f32 kernels] {label}: B {b} H {h} N {n} Dh {dh}, scale {scale:g}")
        elem, rows = b * h * n * dh * 4, b * h * n * 4
        iters = 20 if n < 512 else 5
        recs, fwd_out = {}, {}
        for mode in fwd_modes:
            name = A.launch_key("flash_attn_fwd", mode, f32)
            kern = lambda mode=mode: A.flash_forward(q, k, v, scale, score_mode=mode)  # noqa
            plain = lambda mode=mode: A.attention_forward_reference(q, k, v, scale, mode)  # noqa
            (o, lse), (po, plse) = kern(), plain()
            err, bar = _rel_err(o, po, own=False)
            lse_err = (lse - plse).abs().max().item()
            ob, _ = A.flash_forward(qb, kb, vb, scale, score_mode=mode)
            bf_err, _ = _rel_err(ob, po, own=False)
            print(f"  {name} {label}: max_abs_err {err:.4g} (bar {F32_RTOL * bar:.4g}), lse "
                  f"{lse_err:.4g} (bar {F32_LSE_TOL}), the bf16 kernel's {bf_err:.4g}")
            if not (err <= F32_RTOL * bar and lse_err <= F32_LSE_TOL and err <= 0.5 * bf_err
                    and o.is_contiguous()):
                raise AssertionError(f"{name} {label}: disagrees with its plain version, or not "
                                     "half the bf16 kernel's error, or not contiguous")
            library = None
            if mode == "dot":
                library = lambda: F.scaled_dot_product_attention(q, k, v, scale=inv)  # noqa
            elif mode == "l2":
                library = _l2_library(q, k, v, inv)
            bound_ms, bound_by = _bound_f32(4.0 * b * h * n * n * dh, 4 * elem + rows)
            recs[name] = {"max_abs_err": err, "lse_max_abs_err": lse_err,
                          "bf16_max_abs_err": bf_err, "ms": _time_ms(kern, iters),
                          "plain_ms": _time_ms(plain, 3), "bound_ms": bound_ms,
                          "bound_by": bound_by,
                          "library_ms": _time_ms(library, iters) if library else None}
            if F32_MAIN[name] == label:
                recs[name]["device_ms"], recs[name]["other_device_ms"] = _device_ms(
                    kern, iters, F32_SYMBOLS["flash_attn_fwd"])
            fwd_out[mode] = (o, lse)
            del ob, po, plse
        for kind, modes in bwd_modes.items():
            base, kern_fn, plain_fn, products, writes = bwd[kind]
            for mode in modes:
                name = A.launch_key(base, mode, f32)
                o, lse = fwd_out[mode] if mode in fwd_out else A.flash_forward(
                    q, k, v, scale, score_mode=mode)
                args = (q, k, v, o, lse, do, scale)
                kern = lambda mode=mode, args=args, fn=kern_fn: fn(*args, score_mode=mode)  # noqa
                plain = lambda mode=mode, args=args, fn=plain_fn: fn(*args, score_mode=mode)  # noqa
                got, want = kern(), plain()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                bgot = kern_fn(qb, kb, vb, o.bfloat16(), lse, dob, scale, score_mode=mode)
                bgot = bgot if isinstance(bgot, tuple) else (bgot,)
                errs, bf_errs = [], []
                for i, (g_, w_, b_) in enumerate(zip(got, want, bgot)):
                    err, bar = _rel_err(g_, w_, own=True)
                    bf_err, _ = _rel_err(b_, w_, own=True)
                    print(f"  {name} {label} out{i}: max_abs_err {err:.4g} (bar "
                          f"{F32_RTOL * bar:.4g}), the bf16 kernel's {bf_err:.4g}")
                    if not (err <= F32_RTOL * bar and err <= 0.5 * bf_err
                            and g_.is_contiguous()):
                        raise AssertionError(f"{name} {label} out{i}: disagrees with its plain "
                                             "version, or not half the bf16 kernel's error, or "
                                             "not contiguous")
                    errs.append(err)
                    bf_errs.append(bf_err)
                del got, want, bgot
                repeat = _repeat(kern, f"{name} {label}")
                bound_ms, bound_by = _bound_f32(2.0 * products * b * h * n * n * dh,
                                                (5 + writes) * elem + rows)
                library_ms = None
                if mode == "dot" or mode == "l2":
                    xs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
                    lib_out = (F.scaled_dot_product_attention(*xs, scale=inv) if mode == "dot"
                               else _l2_library(*xs, inv)())
                    library_ms = _time_ms(lambda: torch.autograd.grad(
                        lib_out, xs, do, retain_graph=True), iters)
                    del xs, lib_out
                recs[name] = {"max_abs_err": max(errs), "max_abs_err_per_output": errs,
                              "bf16_max_abs_err_per_output": bf_errs,
                              "repeat_max_abs_diff": repeat, "ms": _time_ms(kern, iters),
                              "plain_ms": _time_ms(plain, 3), "bound_ms": bound_ms,
                              "bound_by": bound_by, "library_ms": library_ms}
                if F32_MAIN[name] == label:
                    recs[name]["device_ms"], recs[name]["other_device_ms"] = _device_ms(
                        kern, iters, F32_SYMBOLS[base])
        for name, r in recs.items():
            dev = (f"; device {r['device_ms']} ms in its kernels, {r['other_device_ms']} in the "
                   "wrapper's other work" if "device_ms" in r else "")
            print(f"  {name} {label}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
                  f"{r['library_ms']}, bound {r['bound_ms']:.4f} ms by {r['bound_by']}{dev})")
            if F32_MAIN[name] == label:
                out[name].update({"shape": list(shape), "scale": scale, **r})
            else:
                tag = label.replace(" ", "_")
                out[name][f"{tag}_max_abs_err"] = r["max_abs_err"]
                out[name][f"{tag}_ms"] = r["ms"]
                out[name][f"{tag}_bound_ms"] = r["bound_ms"]
                out[name][f"{tag}_plain_ms"] = r["plain_ms"]
                out[name][f"{tag}_library_ms"] = r["library_ms"]
                if "repeat_max_abs_diff" in r:
                    out[name][f"{tag}_repeat_max_abs_diff"] = r["repeat_max_abs_diff"]
        del q, k, v, do, qb, kb, vb, dob, fwd_out
        torch.cuda.empty_cache()
    return out


# Kernel launches per v1 train step at the reference defaults in f32 under
# use_pallas=always: V1_KERNELS' counts on the f32 kernels (G's `dot` single
# pass at 32 tokens; D's `l2` two-pass at 50 tokens under bwd_fusion=auto).
V1_F32_KERNELS = {"flash_attn_fwd_f32[dot]": 4, "flash_attn_fwd_f32[l2]": 8,
                  "flash_attn_bwd_dq_f32[l2]": 8, "flash_attn_bwd_dkv_f32[l2]": 8,
                  "flash_attn_bwd_fused_f32[dot]": 4}


def train_v1_f32(run_dir: str) -> tuple:
    """[train v1 f32]: the v1 ViTGAN at the reference defaults with
    runtime.compute_dtype=float32 under use_pallas=always through Trainer.fit
    on 1,024 synthetic samples (8 steps an epoch): 1 eager warm-up step, 3
    eager steps timed, a warm-up epoch (the capture), then a timed epoch of
    captured steps; launches a step held to V1_F32_KERNELS (no bf16 flash
    kernel, no plain attention); the run directory served over HTTP (the f32
    forward kernel in every G block of each call).  Then captured against
    eager (bit-equal), one step at dropout 0 on each bwd_fusion route against
    use_pallas=never in f32 (compare_v1_train_routes; bwd_fusion=fused sends
    D to the `l2` single pass, two_pass G to `dot` dq and dk/dv) and the
    `l2ref` route in f32.  Returns (launches of the fit's steps, record)."""
    import numpy as np
    import torch

    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.serve import serve
    from vitgan_tpu_torch.train.step import host_metrics
    from vitgan_tpu_torch.train.trainer import Trainer

    tag = "[train v1 f32]"
    over = {"runtime.compute_dtype": "float32"}
    cfg = _v1_cfg(**_fit_over({**over, "data.synthetic_samples": 1024, "run.epochs": 2}))
    m = cfg.v1
    t0 = time.perf_counter()
    trainer = Trainer(cfg, run_dir=run_dir, device="cuda")
    st, steps = trainer.state, trainer.steps_per_call
    print(f"{tag} v1 defaults in {cfg.runtime.compute_dtype}: batch {m.batch_size}, use_pallas "
          f"{cfg.runtime.use_pallas}, bwd_fusion {cfg.runtime.bwd_fusion}; {steps} steps a call; "
          f"set up in {time.perf_counter() - t0:.1f} s")
    before = [p.detach().cpu().clone() for p in (*st.g.parameters(), *st.d.parameters())]
    host_metrics(trainer.train_step(st, trainer.real_batch(trainer.batches()[0])))
    eager_ms = _eager_step_ms(trainer, 3)
    grid = _grid_launches(trainer)
    with _PlainAttentionCounter() as plain:
        trainer.fit(epochs=1)  # the warm-up epoch: its first step runs eagerly, then is captured
        _settle()
        torch.cuda.synchronize()
        build.reset_launches()
        # --- the v1 f32 path ---
        means = trainer.fit()
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        # --- end of the v1 f32 path ---
    ms = 1e3 * m.batch_size / means["images_per_sec"]
    print(f"{tag} {_smi()}: {steps} captured steps by Trainer.fit: {ms:.3f} ms/step "
          f"({means['images_per_sec']:.1f} img/s); the eager step {eager_ms:.3f} ms; launches "
          f"{ {k: v for k, v in launches.items() if v} }; the grid's alone {grid}; plain "
          f"attention calls {plain.calls}")
    launches = _check_fit_launches(tag, launches, V1_F32_KERNELS, steps, grid)
    if plain.calls:
        raise AssertionError(f"{tag} {plain.calls} attentions took a plain route")
    if not all(math.isfinite(means[k]) for k in ("d_loss", "g_loss", "d_grad_norm",
                                                 "g_grad_norm")):
        raise AssertionError(f"{tag} non-finite train metrics: {means}")
    after = [p.detach().cpu() for p in (*st.g.parameters(), *st.d.parameters())]
    if any(torch.equal(a, b_) for a, b_ in zip(before, after)):
        raise AssertionError(f"{tag} some parameters did not move")
    breakdown = train_breakdown(trainer, ms, recompute=False)
    del trainer, st, before, after
    torch.cuda.empty_cache()
    httpd = serve(run_dir, host="127.0.0.1", port=0, batch=64)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        torch.cuda.synchronize()
        build.reset_launches()
        status, _, body, req_ms = _post(f"http://127.0.0.1:{httpd.server_address[1]}",
                                        {"n": 16, "seed": 1, "format": "npy"})
        torch.cuda.synchronize()
        served = {k: v for k, v in build.LAUNCHES.items() if v}
    finally:
        httpd.shutdown()
        httpd.server_close()
    arr = np.load(io.BytesIO(body))
    print(f"{tag} the run directory served POST npy n=16 in {req_ms:.1f} ms, launches {served}")
    if status != 200 or arr.shape != (16, 32, 32, 3) or not np.isfinite(arr).all() \
            or arr.std() < 1e-3 or served != {"flash_attn_fwd_f32[dot]": 4}:
        raise AssertionError(f"{tag} serving the f32 run directory: {status} {arr.shape}, "
                             f"launches {served}")
    capture = captured_vs_eager(_v1_cfg(**_fit_over(over)), 4, "v1 f32 use_pallas=always")
    if not capture["bit_equal"]:
        raise AssertionError(f"{tag} the captured steps are not bit-equal to eager ones")
    routes = compare_v1_train_routes(dtype="float32")
    l2ref = l2ref_path("float32")
    return launches, {"card": _smi(), "ms_per_step": ms, "eager_ms_per_step": eager_ms,
                      "img_per_s": means["images_per_sec"], "steps": steps, "means": means,
                      "breakdown": breakdown, "serve_ms": req_ms, "serve_launches": served,
                      "captured_vs_eager": capture, "routes": routes, "l2ref": l2ref}


# [ln_mlp activations]: the fc1 stage with each activation at highres128's
# serving rows (E 384: the resident kernel) and DeiT-B's G rows (E 768: the
# wide variant, ln_rows then the streamed fc1).
ACT_SHAPES = (("highres128 serving", (64 * 1024, 384, 1536)), ("E 768", (64 * 256, 768, 3072)))


def check_ln_mlp_activations() -> dict:
    """Each activation of the fc1 epilogue (gelu, relu, tanh, sigmoid) at
    ACT_SHAPES: h and z1 against the stage's plain version within KERNEL_RTOL
    * max(1, max|plain|), bit-equal across two calls, timed beside GELU's.
    Returns {label: {activation: record}}."""
    import torch

    from vitgan_tpu_torch.ops import fused_mlp as FM

    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    out = {}
    for label, (m, e, hidden) in ACT_SHAPES:
        def rn(*shape, scale=1.0, dtype=torch.bfloat16):
            return (scale * torch.randn(shape, generator=gen, device="cuda")).to(dtype)

        a = rn(m, e)
        ln_s, ln_b = 1.0 + rn(e, scale=0.1, dtype=torch.float32), rn(e, scale=0.1,
                                                                     dtype=torch.float32)
        w1, b1 = rn(e, hidden, scale=0.05), rn(hidden, scale=0.1, dtype=torch.float32)
        print(f"[ln_mlp activations] {label}: rows {m} E {e} hidden {hidden} "
              f"({'wide' if FM.wide_route(e) else 'resident'})")
        out[label] = {}
        for act in FM.ACTIVATIONS:
            kern = lambda act=act: FM.ln_fc1_stage(a, ln_s, ln_b, w1, b1, want_z1=True,  # noqa
                                                   activation=act)
            h, z1 = kern()
            want_h, want_z1 = FM.ln_fc1_stage_reference(a, ln_s, ln_b, w1, b1, activation=act)
            rec = {"h_max_abs_err": _err(h, want_h, f"fc1 {act} {label} h"),
                   "z1_max_abs_err": _err(z1, want_z1, f"fc1 {act} {label} z1"),
                   "repeat_max_abs_diff": _repeat(kern, f"fc1 {act} {label}"),
                   "ms": _time_ms(kern, 20)}
            out[label][act] = rec
            del h, z1, want_h, want_z1
        gelu = out[label]["gelu"]["ms"]
        print(f"[ln_mlp activations] {label} {_smi()}: fc1 ms " + ", ".join(
            f"{act} {r['ms']:.4f} ({r['ms'] / gelu:.3f} of gelu's)"
            for act, r in out[label].items()))
        del a, w1
        torch.cuda.empty_cache()
    return out


# --- the LayerNorm family's f32 forward (csrc/ln_f32.cuh) ------------------------------

# (label, (B, N, E, heads, hidden)): highres128's serving call and its G and D
# training rows, highres256p4's G, DeiT-B's G (E 768) and a ragged deit64
# batch (E 192, 3 heads of 64).
F32_LN_SHAPES = (("highres128 serving", (64, 1024, 384, 6, 1536)),
                 ("highres128 G", (32, 1024, 384, 6, 1536)),
                 ("highres128 D", (32, 1025, 384, 6, 1536)),
                 ("highres256p4 G", (8, 4096, 384, 6, 1536)),
                 ("DeiT-B G", (64, 256, 768, 12, 3072)),
                 ("deit64 ragged", (2, 257, 192, 3, 768)))
F32_LN_KERNELS = ("ln_mlp_fc1_f32", "ln_mlp_linear_f32", "ln_qkv_fwd_f32")
# name: (source, the TPU kernel replaced) in the JSON line
F32_LN_META = {"ln_mlp_fc1_f32": ("ln_mlp_fc1_f32.cu", "vitgan_tpu/ops/fused_mlp.py:133"),
               "ln_mlp_linear_f32": ("ln_mlp_linear_f32.cu", "vitgan_tpu/ops/fused_mlp.py:133"),
               "ln_qkv_fwd_f32": ("ln_qkv_fwd_f32.cu", "vitgan_tpu/ops/fused_block.py:408")}
F32_LN_MAIN = "highres128 G"  # each entry's main record: the megablock's training rows
# The parts of the CUDA symbols of the entries' kernels that the profiler
# counts: the LayerNorm rows and the A . W^T tile's forward epilogues (the
# K-major weight copies, PyTorch's copy kernels, count as the call's other
# device work); and a parent's mma.sync kernels, which scripts/kernel_ab.py
# --f32-ln measures.
F32_LN_SYMBOL = ("ln_norm_f32_kernel", "tile_f32_kernel<3,", "tile_f32_kernel<4,",
                 "tile_f32_kernel<5,", "ln_gemm_f32_kernel", "ln_stats_f32_kernel")


def check_f32_ln_kernels() -> dict:
    """[f32 ln kernels]: the LayerNorm family's f32 entries at F32_LN_SHAPES
    (LN -> fc1 with z1, the linear stage as fc2 with the residual and a 0.1
    dropout mask, LN1 -> qkv into (3, B, H, N, Dh)) against their plain
    versions in full f32, each output within F32_RTOL * max(1, max|plain|)
    and at most half the bf16 kernel's error on the same inputs cast to
    bf16; the linear stage's mask bit-equal to the plain mask and to the bf16
    stage's at the same seed and rows; every output bit-equal across two
    calls; timed (the wrapper, the device time of its kernel at F32_LN_MAIN,
    the plain version, the TF32 bound, and F.layer_norm then torch.matmul of
    the products in f32 and in TF32).  Then the f32 flash forward into the
    megablock's (B, N, H*Dh) layout at highres128's G, bit-equal to its
    (B, H, N, Dh) output.  Returns {entry: record} and the layout's record
    under "flash_attn_fwd_f32[dot]"."""
    import torch
    import torch.nn.functional as F

    from vitgan_tpu_torch.ops import attention as A
    from vitgan_tpu_torch.ops import fused_block as FB
    from vitgan_tpu_torch.ops import fused_mlp as FM

    tag = "[f32 ln kernels]"
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    seed = torch.tensor([SEED + 7], dtype=torch.int64, device="cuda")
    out = {name: {} for name in F32_LN_KERNELS}
    layout = {}

    def rn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    for label, (b, n, e, heads, hidden) in F32_LN_SHAPES:
        m, dh = b * n, e // heads
        x = rn(m, e)
        ln_s, ln_b = 1.0 + rn(e, scale=0.1), rn(e, scale=0.1)
        w1, b1 = rn(e, hidden, scale=e ** -0.5), rn(hidden, scale=0.1)
        a, w2, b2 = rn(m, hidden, scale=0.5), rn(hidden, e, scale=hidden ** -0.5), rn(e, scale=0.1)
        qkv_w, qkv_b = rn(3, heads, e, dh, scale=e ** -0.5), rn(3 * heads * dh, scale=0.1)
        wqkv, x3 = FB._qkv_weight(qkv_w, f32), x.reshape(b, n, e)
        mask = FB.dropout_mask(seed, 1, (m, e), MB_RATE)
        print(f"{tag} {label}: {m} rows, E {e}, hidden {hidden}, {heads} heads of {dh}")
        layer_norm = lambda: F.layer_norm(x, (e,), ln_s, ln_b)  # noqa: E731
        # name: (the wrapper in a dtype, its plain version in f32, the library
        # row, flops, bytes each input read once and each output written once)
        cases = {
            "ln_mlp_fc1_f32": (
                lambda dt: FM.ln_fc1_stage(x.to(dt), ln_s, ln_b, w1, b1, want_z1=True),
                lambda: FM.ln_fc1_stage_reference(x, ln_s, ln_b, w1, b1, dtype=f32),
                lambda: torch.matmul(layer_norm(), w1),
                2.0 * m * e * hidden, 4.0 * (m * e + 2 * e + e * hidden + hidden + 2 * m * hidden)),
            "ln_mlp_linear_f32": (
                lambda dt: FM.linear_stage(a.to(dt), w2, b2, x.to(dt), seed, MB_RATE, 1),
                lambda: (FM.linear_stage_reference(a, w2, b2, x, mask, f32), mask),
                lambda: torch.matmul(a, w2),
                2.0 * m * hidden * e, 4.0 * (m * hidden + hidden * e + e + 3 * m * e)),
            "ln_qkv_fwd_f32": (
                lambda dt: FB.ln_qkv_forward(x3.to(dt), ln_s, ln_b, qkv_w, qkv_b),
                lambda: FB._ln_qkv_reference(x3, ln_s, ln_b, qkv_w, qkv_b),
                lambda: torch.matmul(layer_norm(), wqkv),
                6.0 * m * e * e, 4.0 * (m * e + 2 * e + 3 * e * e + 3 * e + 3 * m * e)),
        }
        iters = 5 if m > 32768 else 10
        for name, (kern, plain, library, flops, nbytes) in cases.items():
            k32 = lambda kern=kern: kern(f32)  # noqa: E731
            got, want, bgot = (t if isinstance(t, tuple) else (t,)
                               for t in (k32(), plain(), kern(bf16)))
            errs, bf_errs = [], []
            for i, (g_, w_, b_) in enumerate(zip(got, want, bgot)):
                if name == "ln_mlp_linear_f32" and i == 1:  # the mask
                    same = torch.equal(g_, w_) and torch.equal(g_, b_)
                    print(f"  {name} {label} mask: {'bit-equal' if same else 'NOT bit-equal'} "
                          "to the plain mask and the bf16 stage's")
                    if not same:
                        raise AssertionError(f"{tag} {label}: the f32 mask is not the bf16 one")
                    continue
                if g_.dtype != f32:
                    raise AssertionError(f"{tag} {name} {label}: output {i} is {g_.dtype}")
                err, bar = _rel_err(g_, w_, own=False)
                bf_err, _ = _rel_err(b_, w_, own=False)
                print(f"  {name} {label} out{i}: max_abs_err {err:.4g} (bar "
                      f"{F32_RTOL * bar:.4g}), the bf16 kernel's {bf_err:.4g}")
                if not (err <= F32_RTOL * bar and err <= 0.5 * bf_err):
                    raise AssertionError(f"{tag} {name} {label} out{i}: disagrees with its "
                                         "plain version, or not half the bf16 kernel's error")
                errs.append(err)
                bf_errs.append(bf_err)
            del got, want, bgot
            repeat = _repeat(k32, f"{name} {label}")
            bound_ms, bound_by = _bound_f32(flops, nbytes)
            rec = {"max_abs_err": max(errs), "max_abs_err_per_output": errs,
                   "bf16_max_abs_err_per_output": bf_errs, "repeat_max_abs_diff": repeat,
                   "ms": _time_ms(k32, iters), "plain_ms": _time_ms(plain, 3),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": _time_ms(library, iters)}
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                rec["library_tf32_ms"] = _time_ms(library, iters)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            if label == F32_LN_MAIN:
                rec["device_ms"], rec["other_device_ms"] = _device_ms(k32, iters, F32_LN_SYMBOL)
            print(f"  {name} {label} {_smi()}: {rec['ms']:.4f} ms (device "
                  f"{rec.get('device_ms')}), bound {bound_ms:.4f} ms by {bound_by}, plain "
                  f"{rec['plain_ms']:.4f}, F.layer_norm + torch.matmul in f32 "
                  f"{rec['library_ms']:.4f}, in TF32 {rec['library_tf32_ms']:.4f}")
            if label == F32_LN_MAIN:
                out[name].update({"shape": [b, n, e, heads, hidden], **rec})
            else:
                key = label.replace(" ", "_")
                out[name][key] = {k: rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                                      "bound_ms", "bound_by", "library_ms",
                                                      "library_tf32_ms", "repeat_max_abs_diff")}
        if label == F32_LN_MAIN:
            qkv = FB.ln_qkv_forward(x3, ln_s, ln_b, qkv_w, qkv_b)
            attn = torch.empty((b, n, heads * dh), device="cuda")
            fwd = lambda: A.flash_forward(qkv[0], qkv[1], qkv[2], float(dh), out=attn)  # noqa
            fwd_bhnd = lambda: A.flash_forward(qkv[0], qkv[1], qkv[2], float(dh))  # noqa
            (o_bnhd, lse), (o, lse2) = fwd(), fwd_bhnd()
            torch.cuda.synchronize()
            same = torch.equal(o_bnhd, o.transpose(1, 2).reshape(b, n, heads * dh)) and \
                torch.equal(lse, lse2)
            layout = {"shape": [b, heads, n, dh], "bit_equal": same,
                      "ms": _time_ms(fwd, iters), "bhnd_ms": _time_ms(fwd_bhnd, iters)}
            print(f"  flash_attn_fwd_f32[dot] {label}: out= (B, N, H*Dh) "
                  f"{'bit-equal' if same else 'NOT bit-equal'} to (B, H, N, Dh); "
                  f"{layout['ms']:.4f} ms against {layout['bhnd_ms']:.4f}")
            if not same:
                raise AssertionError(f"{tag} the f32 flash forward's (B, N, H*Dh) layout")
            del qkv, attn, o_bnhd, o
        del x, a, w1, w2, qkv_w, mask
        torch.cuda.empty_cache()
    out["flash_attn_fwd_f32[dot]"] = {"out_bnhd": layout}
    return out


# --- the saved backward in f32 (csrc/tile_f32.cuh, ln_rows.cuh on f32) ------------------

# (label, (B, N, E, heads, hidden)): highres128's G and D training rows,
# deit64's ragged batch (E 192, 3 heads of 64) and DeiT-B's G (E 768).
F32_BWD_SHAPES = (("highres128 G", (32, 1024, 384, 6, 1536)),
                  ("highres128 D", (32, 1025, 384, 6, 1536)),
                  ("deit64", (128, 257, 192, 3, 768)),
                  ("DeiT-B G", (64, 256, 768, 12, 3072)))
F32_BWD_MAIN = "highres128 G"  # each entry's main record: the megablock's G block
# name: (source, the part of its CUDA symbols the profiler counts)
F32_BWD_META = {
    "megablock_bwd_mask_rows_f32": ("megablock_bwd_mask_rows_f32.cu", ("mask_rows_kernel",)),
    "megablock_bwd_mlp_dz1_f32": ("megablock_bwd_mlp_dz1_f32.cu",
                                  ("tile_f32_kernel<0,", "dy_gemm_f32_kernel")),
    "megablock_bwd_dy_f32": ("megablock_bwd_dy_f32.cu",
                             ("tile_f32_kernel<1,", "dy_gemm_f32_kernel")),
    "megablock_bwd_mlp_dx1_rows_f32": ("megablock_bwd_mlp_dx1_rows_f32.cu",
                                       ("ln_bwd_rows_kernel",)),
    "megablock_bwd_mlp_dao_f32": ("megablock_bwd_mlp_dao_f32.cu",
                                  ("tile_f32_kernel<2,", "dy_gemm_f32_kernel")),
    "megablock_bwd_ln1_rows_f32": ("megablock_bwd_ln1_rows_f32.cu", ("ln_bwd_rows_kernel",)),
    # (wgrad_f32_kernel: a parent's mma.sync product, which scripts/kernel_ab.py measures)
    "wgrad_gemm_f32": ("wgrad_gemm_f32.cu", ("wgrad_tf32_kernel", "wgrad_f32_kernel",
                                             "wgrad_reduce_kernel")),
}


def _f32_bwd_record(tag: str, name: str, label: str, kern, plain, library, flops: float,
                    nbytes: float, iters: int, main: bool) -> dict:
    """One f32 backward entry at one shape: ``kern(dtype)`` (the wrapper on
    the inputs in that dtype) against ``plain()`` in full f32, each output
    f32, within F32_RTOL * max(1, max|plain|) and at most half the bf16
    kernel's error on the same inputs cast to bf16; bit-equal across two
    calls; timed beside the plain version, the TF32 bound and ``library``
    (torch.matmul of the product in TF32, or one PyTorch call of the same
    function; None where there is none)."""
    import torch

    k32 = lambda: kern(torch.float32)  # noqa: E731
    got, want, bgot = ((t,) if torch.is_tensor(t) else tuple(t) for t in (k32(), plain(),
                                                                         kern(torch.bfloat16)))
    errs, bf_errs = [], []
    for i, (g_, w_, b_) in enumerate(zip(got, want, bgot)):
        if g_.dtype != torch.float32:
            raise AssertionError(f"{tag} {name} {label}: output {i} is {g_.dtype}")
        err, bar = _rel_err(g_, w_, own=False)
        bf_err, _ = _rel_err(b_, w_, own=False)
        print(f"  {name} {label} out{i}: max_abs_err {err:.4g} (bar {F32_RTOL * bar:.4g}), "
              f"the bf16 kernel's {bf_err:.4g}")
        if not (err <= F32_RTOL * bar and err <= 0.5 * bf_err):
            raise AssertionError(f"{tag} {name} {label} out{i}: disagrees with its plain "
                                 "version, or not half the bf16 kernel's error")
        errs.append(err)
        bf_errs.append(bf_err)
    del got, want, bgot
    repeat = _repeat(k32, f"{name} {label}")
    bound_ms, bound_by = _bound_f32(flops, nbytes)
    rec = {"max_abs_err": max(errs), "max_abs_err_per_output": errs,
           "bf16_max_abs_err_per_output": bf_errs, "repeat_max_abs_diff": repeat,
           "ms": _time_ms(k32, iters), "plain_ms": _time_ms(plain, 3), "bound_ms": bound_ms,
           "bound_by": bound_by, "flops": flops, "bytes": nbytes, "library_ms": None}
    if library is not None:
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            rec["library_ms"] = _time_ms(library, iters)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    if main:
        rec["device_ms"], rec["other_device_ms"] = _device_ms(k32, iters, F32_BWD_META[name][1])
    print(f"  {name} {label} {_smi()}: {rec['ms']:.4f} ms (device {rec.get('device_ms')}), "
          f"bound {bound_ms:.4f} ms by {bound_by}, plain {rec['plain_ms']:.4f}, library "
          f"{rec['library_ms']}")
    return rec


def check_f32_bwd_kernels() -> dict:
    """[f32 bwd kernels]: the saved backward's f32 entries at F32_BWD_SHAPES
    (the dmlp rows g * m2, dz1 with h1, dy2 = dz1 . w1^T, the dx1 rows, dao
    with delta, the LN1 rows after dy1 = dqkv . wqkv^T, and wgrad_gemm_f32's
    four products of a block) against their plain versions in full f32 by
    _f32_bwd_record's bars, each timed beside its bound, its plain version
    and torch.matmul of its products in TF32 (torch.mul for the dmlp rows).
    dy1 is recorded beside dy2 under megablock_bwd_dy_f32, and the four
    products under wgrad_gemm_f32, whose main numbers are a block's four
    calls together.  Returns {entry: record at F32_BWD_MAIN, the other shapes
    beside}."""
    import torch

    from vitgan_tpu_torch.ops import fused_block as FB
    from vitgan_tpu_torch.ops import wgrad as WG

    tag = "[f32 bwd kernels]"
    f32 = torch.float32
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    out = {name: {} for name in F32_BWD_META}

    def rn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    for label, (b, n, e, heads, hidden) in F32_BWD_SHAPES:
        m, dh, hd = b * n, e // heads, e
        g, x, x1, ao, y1, y2, dx1 = (rn(m, e) for _ in range(7))
        z1, dqkv = rn(m, hidden), rn(m, 3 * hd, scale=0.1)
        m1, m2 = ((torch.rand((m, e), generator=gen, device="cuda") >= MB_RATE).float()
                  / (1 - MB_RATE) for _ in range(2))
        ln_s, ln_b = 1.0 + rn(e, scale=0.1), rn(e, scale=0.1)
        w1, w2 = rn(e, hidden, scale=e ** -0.5), rn(hidden, e, scale=hidden ** -0.5)
        wout, qkv_w = rn(hd, e, scale=hd ** -0.5), rn(3, heads, e, dh, scale=e ** -0.5)
        wqkv = FB._qkv_weight(qkv_w, f32)
        dmlp = FB.bwd_dmlp_rows_reference(g, m2, f32)
        dz1, h1 = FB.bwd_dz1_stage_reference(dmlp, None, z1, w2, f32)[1:]
        dy2, dy1 = FB.bwd_dy_reference(dz1, w1), FB.bwd_dy_reference(dqkv, wqkv)
        da = FB.bwd_dx1_rows_reference(dy2, g, m1, x1, ln_s, ln_b, dtype=f32)[1]
        part = -(-m // 64) * 2 * e * 4
        print(f"{tag} {label}: {m} rows, E {e}, hidden {hidden}, {heads} heads of {dh}")
        main, iters = label == F32_BWD_MAIN, 5 if m > 16384 else 10
        # name: (the wrapper in a dtype, its plain version, the library call,
        # flops, bytes each input read once and each output written once)
        cases = {
            "megablock_bwd_mask_rows_f32": (
                lambda dt: FB.bwd_dmlp_rows(g.to(dt), m2),
                lambda: FB.bwd_dmlp_rows_reference(g, m2, f32), lambda: torch.mul(g, m2),
                0.0, 4.0 * 3 * m * e),
            "megablock_bwd_mlp_dz1_f32": (
                lambda dt: FB.bwd_dz1_stage(dmlp.to(dt), None, z1.to(dt), w2)[1:],
                lambda: FB.bwd_dz1_stage_reference(dmlp, None, z1, w2, f32)[1:],
                lambda: torch.matmul(dmlp, w2.t()),
                2.0 * m * e * hidden, 4.0 * (m * e + 3 * m * hidden + hidden * e)),
            "megablock_bwd_dy_f32": (
                lambda dt: FB.bwd_dy(dz1.to(dt), w1), lambda: FB.bwd_dy_reference(dz1, w1),
                lambda: torch.matmul(dz1, w1.t()),
                2.0 * m * hidden * e, 4.0 * (m * hidden + e * hidden + m * e)),
            "megablock_bwd_mlp_dx1_rows_f32": (
                lambda dt: FB.bwd_dx1_rows(dy2, g.to(dt), m1, x1.to(dt), ln_s, ln_b),
                lambda: FB.bwd_dx1_rows_reference(dy2, g, m1, x1, ln_s, ln_b, dtype=f32),
                None, 0.0, 4.0 * (7 * m * e + 2 * e) + part),
            "megablock_bwd_mlp_dao_f32": (
                lambda dt: FB.bwd_dao_stage(da.to(dt), ao.to(dt), wout, b, n, heads),
                lambda: FB.bwd_dao_stage_reference(da, ao, wout, b, n, heads, f32),
                lambda: torch.matmul(da, wout.t()),
                2.0 * m * e * hd, 4.0 * (m * e + 2 * m * hd + hd * e + b * heads * n)),
            "megablock_bwd_ln1_rows_f32": (
                lambda dt: FB.bwd_ln1_rows(dy1, x.to(dt), dx1, ln_s, ln_b),
                lambda: FB.bwd_ln1_rows_reference(dy1, x, dx1, ln_s, ln_b),
                None, 0.0, 4.0 * (5 * m * e + 2 * e) + part),
        }
        recs = {}
        for name, (kern, plain, library, flops, nbytes) in cases.items():
            recs[name] = _f32_bwd_record(tag, name, label, kern, plain, library, flops, nbytes,
                                         iters, main)
        # dy1 = dqkv . wqkv^T, the LN1 half's product, beside dy2
        recs["megablock_bwd_dy_f32"]["dy1"] = _f32_bwd_record(
            tag, "megablock_bwd_dy_f32", f"{label} dy1",
            lambda dt: FB.bwd_dy(dqkv.to(dt), wqkv), lambda: FB.bwd_dy_reference(dqkv, wqkv),
            lambda: torch.matmul(dqkv, wqkv.t()), 2.0 * m * 3 * hd * e,
            4.0 * (m * 3 * hd + 3 * hd * e + m * e), iters, main)
        # wgrad_gemm_f32: the four products of a block, and their sum
        products = {}
        for prod, (a, bb) in {"dW2": (h1, dmlp), "dW1": (y2, dz1), "dWout": (ao, da),
                              "dWqkv": (y1, dqkv)}.items():
            ka, nb = a.shape[1], bb.shape[1]
            products[prod] = _f32_bwd_record(
                tag, "wgrad_gemm_f32", f"{label} {prod}",
                lambda dt, a=a, bb=bb: WG.wgrad_gemm(a.to(dt), bb.to(dt)),
                lambda a=a, bb=bb: WG.wgrad_reference(a, bb),
                lambda a=a, bb=bb: torch.matmul(a.t(), bb), 2.0 * m * ka * nb,
                4.0 * (m * ka + m * nb + ka * nb + nb), iters, main)
        flops = sum(r["flops"] for r in products.values())
        nbytes = sum(r["bytes"] for r in products.values())
        bound_ms, bound_by = _bound_f32(flops, nbytes)
        recs["wgrad_gemm_f32"] = {
            "max_abs_err": max(r["max_abs_err"] for r in products.values()),
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
            **{k: sum(r[k] for r in products.values())
               for k in ("ms", "plain_ms", "library_ms")},
            "repeat_max_abs_diff": max(max(r["repeat_max_abs_diff"]) for r in products.values()),
            "products": products, "what": "a block's four products together"}
        if main:
            recs["wgrad_gemm_f32"]["device_ms"] = sum(r["device_ms"] or 0.0
                                                      for r in products.values())
        print(f"  wgrad_gemm_f32 {label}, four products: {recs['wgrad_gemm_f32']['ms']:.4f} ms, "
              f"bound {bound_ms:.4f} ms by {bound_by}")
        for name, rec in recs.items():
            if main:
                out[name].update({"shape": [b, n, e, heads, hidden], **rec})
            else:
                out[name][label.replace(" ", "_")] = {
                    k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms", "repeat_max_abs_diff")}
        del g, x, x1, ao, y1, y2, dx1, z1, dqkv, m1, m2, dmlp, dz1, h1, dy2, dy1, da, cases
        torch.cuda.empty_cache()
    return out


# --- [v2 f32]: the v2 presets in f32 under `auto` ---------------------------------------

V2_F32 = {"runtime.compute_dtype": "float32"}
# The bf16 kernels' names and the f32 kernels that take their place (the
# LN->MLP forms count both dtypes' calls under one name).
F32_OF = {"ln_qkv_fwd": "ln_qkv_fwd_f32", "flash_attn_fwd": "flash_attn_fwd_f32[dot]",
          "ln_mlp_fc1": "ln_mlp_fc1_f32", "ln_mlp_linear": "ln_mlp_linear_f32",
          "flash_attn_bwd_fused": "flash_attn_bwd_fused_f32[dot]",
          "flash_attn_bwd_dq": "flash_attn_bwd_dq_f32[dot]",
          "flash_attn_bwd_dkv": "flash_attn_bwd_dkv_f32[dot]"}
# Launches of one block of the megablock's f32 serving form: LN1 -> qkv, the
# f32 flash forward into (B, N, H*Dh), the out-projection + LN2 -> MLP.
V2_F32_SERVE = {"ln_qkv_fwd_f32": 1, "flash_attn_fwd_f32[dot]": 1, "proj_ln_mlp_fwd": 1,
                "ln_mlp_fc1_f32": 1, "ln_mlp_linear_f32": 2}
# Launches a step in f32 (36 block forwards with a backward: G; D on [real;
# fake]; D on the fake in the G update).  highres128 under megablock=on,
# megablock_bwd=recompute: the megablock's training forward in each, once
# more in its backward under the preset's remat 'attn' (autograd of the
# plain block differentiates it: no backward kernel).  highres256p4: the
# standard path, the flash backward single pass at G's 4,096 tokens and
# two-pass at D's 4,097 (the JAX rule at f32's K/V bytes).
V2_F32_KERNELS = {
    "recompute": {F32_OF.get(k, k): 2 * 36 * v for k, v in MB_FWD_LAUNCHES.items()},
    # [v2 f32 routes] (dropout 0, remat never): the megablock's f32 serving
    # form in each block forward; under megablock=off #1's f32 stages and the
    # f32 flash kernels (the single pass at G's 1,024 tokens, two-pass at D's
    # 1,025)
    "on_dropout0": {k: 36 * v for k, v in V2_F32_SERVE.items()},
    "off": {F32_OF.get(k, k): v for k, v in TRAIN_KERNELS["off"].items()},
    "p4": {"flash_attn_fwd_f32[dot]": 36, "flash_attn_bwd_fused_f32[dot]": 12,
           "flash_attn_bwd_dq_f32[dot]": 24, "flash_attn_bwd_dkv_f32[dot]": 24,
           "ln_mlp_fwd": 36, "ln_mlp_fc1_f32": 36, "ln_mlp_linear_f32": 36},
}
# The saved backward's f32 launches in place of each bf16 launch of
# TRAIN_KERNELS["auto"]: the MLP half's dx1 stage as dy2 and the dx1 rows,
# the LN1 half as dy1 and the LN1 rows (no megablock_bwd_ln1 call counted).
F32_BWD_OF = {"megablock_bwd_mlp_dz1": ("megablock_bwd_mlp_dz1_f32",),
              "megablock_bwd_mlp_dx1": ("megablock_bwd_dy_f32",
                                        "megablock_bwd_mlp_dx1_rows_f32"),
              "megablock_bwd_mlp_dao": ("megablock_bwd_mlp_dao_f32",),
              "megablock_bwd_ln1": ("megablock_bwd_dy_f32", "megablock_bwd_ln1_rows_f32"),
              "wgrad_gemm": ("wgrad_gemm_f32",)}


def saved_f32_kernels(remat, dropout: bool) -> dict:
    """Launches a highres128 step in f32 on the saved route (megablock=auto,
    megablock_bwd=saved): train_kernels('auto', remat) with each bf16 launch
    replaced by its f32 launches, and with dropout the dmlp rows once a
    block backward."""
    per = {}
    for k, v in train_kernels("auto", remat).items():
        for name in F32_BWD_OF.get(k, (F32_OF.get(k, k),)):
            per[name] = per.get(name, 0) + v
    if dropout:
        per["megablock_bwd_mask_rows_f32"] = per["megablock_bwd_mlp"]
    return per


V2_F32_KERNELS["saved"] = saved_f32_kernels("attn", True)  # the preset: remat attn, dropout 0.1
V2_F32_KERNELS["saved_dropout0"] = saved_f32_kernels("never", False)  # [v2 f32 routes]
# deit64 at its preset (remat never, dropout 0.1): the same blocks, the flash
# backward the single pass at 256 and 257 tokens in f32
V2_F32_KERNELS["deit64"] = {
    **{k: v for k, v in saved_f32_kernels("never", True).items() if "attn_bwd" not in k},
    "flash_attn_bwd_fused_f32[dot]": 36}
V2_F32_STEPS = 3  # run.steps_per_epoch of [v2 f32]'s highres128 fits
P4_F32_STEPS = 2  # captured highres256p4 steps a call (at most P4_STEPS)
# The bf16 LayerNorm, flash and megablock-backward launches, none of which an
# f32 run may make.
BF16_KERNELS = ("ln_qkv_fwd", "ln_qkv_fwd_wide", "ln_mlp_fc1", "ln_mlp_fc1_wide",
                "ln_mlp_linear", "ln_rows", "flash_attn_fwd", "flash_attn_bwd_fused",
                "flash_attn_bwd_dq", "flash_attn_bwd_dkv", *MB_MLP_STAGES, "megablock_bwd_ln1",
                "megablock_bwd_mask_rows", "megablock_bwd_mlp_dz1_wide", "megablock_bwd_dy",
                "megablock_bwd_mlp_dx1_rows", "megablock_bwd_mlp_dao_wide",
                "megablock_bwd_ln1_rows", "wgrad_gemm")


def _no_bf16_launch(tag: str, launches: dict) -> None:
    bf16 = {k: v for k, v in launches.items() if v and k in BF16_KERNELS}
    if bf16:
        raise AssertionError(f"{tag} bf16 LayerNorm, flash or megablock-backward kernels "
                             f"launched in f32: {bf16}")


def _serve_f32(tag: str, cfg, run_dir: str, calls: int = 3, write: bool = True) -> dict:
    """Serve the run directory ``run_dir`` (first written from ``cfg``'s
    generator, random from SEED, with ``write``) at batch 64 and POST
    ``calls`` seeded n=64 requests: the images' shape, finiteness and
    spread, ms per request (the least), and the launches of the calls, held
    to V2_F32_SERVE a block and checked free of bf16 LayerNorm and flash
    launches when ``cfg`` is f32."""
    import numpy as np
    import torch

    from vitgan_tpu_torch.models import build_gan
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.serve import serve
    from vitgan_tpu_torch.utils.run_dirs import save_run

    m = cfg.v2
    if write:
        g = build_gan(cfg).generator_init(torch.Generator().manual_seed(SEED), device="cpu")
        save_run(run_dir, cfg, g, meta={"step": 0, "seed": SEED})
        del g
    httpd = serve(run_dir, host="127.0.0.1", port=0, batch=64)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        _post(url, {"n": 64, "seed": 0, "format": "npy"})  # warm
        torch.cuda.synchronize()
        build.reset_launches()
        times = []
        for i in range(calls):
            status, _, body, ms = _post(url, {"n": 64, "seed": 1 + i, "format": "npy"})
            times.append(ms)
        torch.cuda.synchronize()
        every = dict(build.LAUNCHES)
    finally:
        httpd.shutdown()
        httpd.server_close()
    launches = {k: v for k, v in every.items() if v}
    arr = np.load(io.BytesIO(body))
    size = m.image_size
    print(f"{tag} {cfg.runtime.compute_dtype} E {m.embed_dim}, {m.num_heads} heads, depth "
          f"{m.depth}: POST npy n=64 x {calls}: {min(times):.1f} ms the least ({times}); "
          f"launches {launches}")
    if status != 200 or arr.shape != (64, size, size, 3) or not np.isfinite(arr).all() \
            or arr.std() < 1e-3:
        raise AssertionError(f"{tag} serving: {status} {arr.shape}")
    if cfg.runtime.compute_dtype == "float32":
        _check_launches(every, V2_F32_SERVE, m.depth * calls)
        _no_bf16_launch(tag, launches)
    return {"ms": min(times), "ms_all": times, "launches_per_call": {
        k: v // calls for k, v in launches.items()}}


def _sample_call_f32(tag: str, cfg, calls: int = 3) -> dict:
    """The serving call (train/sample.make_serve_sample_fn: latents, the
    generator, the uint8 readback) of ``cfg``'s f32 generator, random from
    SEED, at batch 64: ms a call (CUDA events, the least of ``calls`` after a
    warm-up), the images' spread, launches held to V2_F32_SERVE a block."""
    import torch

    from vitgan_tpu_torch.models import build_gan
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.ops.policy import apply_from_runtime, get_policy, set_policy
    from vitgan_tpu_torch.train.sample import make_serve_sample_fn

    m, gan = cfg.v2, build_gan(cfg)
    g = gan.generator_init(torch.Generator().manual_seed(SEED), device="cuda").eval()
    sample = make_serve_sample_fn(gan, cfg, 64)
    saved = get_policy()
    try:
        apply_from_runtime(cfg.runtime)
        sample(g, 0, 0)
        torch.cuda.synchronize()
        build.reset_launches()
        times = []
        for i in range(calls):
            t0 = time.perf_counter()
            u8 = sample(g, 1, i)
            times.append(1e3 * (time.perf_counter() - t0))
        every = dict(build.LAUNCHES)
    finally:
        set_policy(**saved)
    launches = {k: v for k, v in every.items() if v}
    print(f"{tag} {cfg.runtime.compute_dtype} E {m.embed_dim}, {m.num_heads} heads, depth "
          f"{m.depth}: the batch-64 serving call {min(times):.1f} ms the least ({times}); "
          f"launches {launches}")
    if u8.shape != (64, m.image_size, m.image_size, 3) or u8.std() < 1.0:
        raise AssertionError(f"{tag} serving call: {u8.shape}, std {u8.std()}")
    _check_launches(every, V2_F32_SERVE, m.depth * calls)
    _no_bf16_launch(tag, launches)
    del g
    torch.cuda.empty_cache()
    return {"ms": min(times), "ms_all": times, "launches_per_call": {
        k: v // calls for k, v in launches.items()}}


def _bf16_ln_control():
    """The f32 route control's LayerNorm launches: each LN stage wrapper on
    its activations rounded to bf16 (the bf16 kernels), its outputs returned
    in f32.  {(module, name): wrapper} to patch in."""
    from vitgan_tpu_torch.ops import fused_block as FB
    from vitgan_tpu_torch.ops import fused_mlp as FM

    linear, fc1, qkv = FM.linear_stage, FM.ln_fc1_stage, FB.ln_qkv_forward

    def linear_bf16(a, w, bias, res=None, *rest, **kw):
        o, mask = linear(a.bfloat16(), w, bias, None if res is None else res.bfloat16(), *rest,
                         **kw)
        return o.float(), mask

    def fc1_bf16(a, *rest, **kw):
        h, z1 = fc1(a.bfloat16(), *rest, **kw)
        return h.float(), None if z1 is None else z1.float()

    def qkv_bf16(x, *rest, **kw):
        return qkv(x.bfloat16(), *rest, **kw).float()

    return {(FM, "linear_stage"): linear_bf16, (FB, "linear_stage"): linear_bf16,
            (FM, "ln_fc1_stage"): fc1_bf16, (FB, "ln_fc1_stage"): fc1_bf16,
            (FB, "ln_qkv_forward"): qkv_bf16}


F32_LN_CONTROL = "bf16_ln_control"


def _bf16_bwd_control():
    """The saved route's control: the backward's launches (the MLP half, the
    LN1 half, the weight gradients) on their activations rounded to bf16
    (the bf16 kernels), their outputs returned in f32.  {(module, name):
    wrapper} to patch in."""
    from vitgan_tpu_torch.ops import fused_block as FB

    mlp, ln1, wgrad = FB.megablock_bwd_mlp, FB.megablock_bwd_ln1, FB.wgrad

    def mlp_bf16(g, m1, m2, x1, z1, ao, *rest, **kw):
        out = mlp(g.bfloat16(), m1, m2, x1.bfloat16(), z1.bfloat16(), ao.bfloat16(), *rest, **kw)
        return FB.BwdMlp(*(t.float() for t in out))

    def ln1_bf16(dqkv, qkv_w, x, dx1, *rest, **kw):
        dx, y1, part = ln1(dqkv.bfloat16(), qkv_w, x.bfloat16(), dx1, *rest, **kw)
        return dx.float(), y1.float(), part

    def wgrad_bf16(a, b):
        return wgrad(a.bfloat16(), b.bfloat16())

    return {(FB, "megablock_bwd_mlp"): mlp_bf16, (FB, "megablock_bwd_ln1"): ln1_bf16,
            (FB, "wgrad"): wgrad_bf16}


F32_BWD_CONTROL = "bf16_bwd_control"
SAVED_ROUTE = "megablock_saved"
# [v2 f32 routes]: one f32 highres128 step at depth 12 against use_pallas=never
# in full f32.  Every product of a kernel route runs TF32 (the forward kernels,
# the f32 flash kernels, the recompute Functions' backward) through 12 blocks of
# G and of D, forward and back, and the v1 f32 bounds above (4 blocks, only
# attention on the kernels) are missed by every kernel route, the one with a
# full-f32 backward too: on an H100 80GB HBM3 at 700 W losses up to 1.9e-4,
# G's gradient norm 1.2e-3 to 2.5e-3 relative, the worst leaf 3.6e-3 to
# 4.5e-3 of its max|plain|.  These bounds were set from that reading; the
# control F32_LN_CONTROL read losses 5.9e-4 and 1.07e-3, norms 1.1e-4 and
# 5.4e-3, the worst leaf 2.7e-2 there, and must miss one of them.
V2_F32_LOSS_TOL, V2_F32_NORM_RTOL, V2_F32_LEAF_RTOL = 5e-4, 5e-3, 1e-2
# The megablock route with the plain block's backward in full f32 (the
# recompute Functions' products kept out of TF32): what the f32 forward
# kernels move, apart from the shipped route's TF32 backward.
F32_BWD_ROUTE = "megablock_on_recompute_f32_bwd"
V2_F32_ROUTES = ("megablock_on_recompute", F32_BWD_ROUTE, "megablock_off", SAVED_ROUTE,
                 F32_LN_CONTROL, F32_BWD_CONTROL)
V2_F32_CONTROLS = (F32_LN_CONTROL, F32_BWD_CONTROL)


def _full_f32_backward():
    """{(module, name): replacement} keeping the recompute Functions'
    backward products in full f32 (F32_BWD_ROUTE)."""
    import contextlib

    from vitgan_tpu_torch.ops import fused_block as FB
    from vitgan_tpu_torch.ops import fused_mlp as FM

    def no_tf32(on):
        return contextlib.nullcontext()

    return {(FM, "_tf32_products"): no_tf32, (FB, "_tf32_products"): no_tf32}


def compare_v2_f32_routes() -> dict:
    """One highres128 train step in f32 at full width and depth, batch 8,
    dropout 0, remat never, from the same state, batch, latents and augment
    draws: on megablock=on with megablock_bwd=recompute
    (the megablock's f32 forward in every block, autograd of the plain block
    behind it, its products in TF32 as the recompute Functions take them),
    on F32_BWD_ROUTE (the same with that backward in full f32), on
    megablock=off (#1's f32 stages and the f32 flash kernels in every
    block), on SAVED_ROUTE (megablock=auto with the saved backward: the f32
    forward and the saved backward's f32 kernels in every block), on the
    controls F32_LN_CONTROL (the recompute route with its LayerNorm launches
    fed bf16 copies) and F32_BWD_CONTROL (the saved route with its
    backward's launches fed bf16 copies) and on use_pallas=never.  Each route
    is compared with the plain one: losses against V2_F32_LOSS_TOL, gradient
    norms against V2_F32_NORM_RTOL, every leaf's max|d| / max|plain leaf|
    against V2_F32_LEAF_RTOL; the kernel routes must meet the bounds, each
    control must miss one.  What each route misses of the v1 f32 bounds
    (F32_LOSS_TOL, ...) is reported beside.  Launches are held to
    V2_F32_KERNELS (f32 kernels only), the plain route's to none."""
    import torch

    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.data.datasets import synthetic_dataset
    from vitgan_tpu_torch.models import build_gan
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.ops.augment import draw_augment
    from vitgan_tpu_torch.ops.policy import get_policy, set_policy
    from vitgan_tpu_torch.train.sample import latent_rng
    from vitgan_tpu_torch.train.state import create_train_state
    from vitgan_tpu_torch.train.step import host_metrics, make_train_step

    tag, batch = "[v2 f32 routes]", 8
    cfg = C.replace(C.highres_config(128), **{**V2_F32, "v2.batch_size": batch,
                                              "v2.dropout": 0.0})
    gan = build_gan(cfg)
    images, _ = synthetic_dataset(batch, 128, 3, seed=SEED)
    real = torch.from_numpy(images).cuda().float() * (2.0 / 255.0) - 1.0
    z = gan.sample_latent(latent_rng(SEED, 0), batch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    draws = {key: draw_augment(gen, real, cfg.run.diff_augment)
             for key in ("aug_real", "aug_fake", "aug_g")}
    # remat never on every route (remat's steps are bit-equal to never's)
    on = dict(mode="auto", megablock="on", megablock_bwd="recompute", remat="never")
    off = dict(mode="auto", megablock="off", megablock_bwd="saved", remat="never")
    saved_route = dict(mode="auto", megablock="auto", megablock_bwd="saved", remat="never")
    plain = dict(mode="never", megablock="auto", megablock_bwd="saved", remat="never")
    launches_on = V2_F32_KERNELS["on_dropout0"]
    routes = (("megablock_on_recompute", on, launches_on, dict),
              (F32_BWD_ROUTE, on, launches_on, _full_f32_backward),
              ("megablock_off", off, V2_F32_KERNELS["off"], dict),
              (SAVED_ROUTE, saved_route, V2_F32_KERNELS["saved_dropout0"], dict),
              (F32_LN_CONTROL, on, None, _bf16_ln_control),
              (F32_BWD_CONTROL, saved_route, None, _bf16_bwd_control),
              ("plain", plain, {}, dict))
    saved, res, out = get_policy(), {}, {}
    state = create_train_state(gan, cfg, device="cuda")
    start = state.state_dict()  # each route's step starts from it
    try:
        for route, policy, must, patches in routes:
            set_policy(**policy)
            patches = patches()
            originals = {key: getattr(*key) for key in patches}
            for (mod, name), fn in patches.items():
                setattr(mod, name, fn)
            try:
                state.load_state_dict(start)
                step = make_train_step(gan, cfg)
                build.reset_launches()
                t0 = time.perf_counter()
                metrics = host_metrics(step(state, real, z=z, draws=draws))
                sec = time.perf_counter() - t0
            finally:
                for (mod, name), fn in originals.items():
                    setattr(mod, name, fn)
            launched = {k: v for k, v in build.LAUNCHES.items() if v}
            # copied: the next route's step refills the state's gradient tensors
            res[route] = (metrics, [p.grad.float().clone() for p in (*state.g.parameters(),
                                                                     *state.d.parameters())],
                          [f"g.{n}" for n, _ in state.g.named_parameters()]
                          + [f"d.{n}" for n, _ in state.d.named_parameters()])
            print(f"{tag} {route}: {sec:.2f} s, launches {launched}, metrics {metrics}")
            if must is not None and launched != must:
                raise AssertionError(f"{tag} {route} launched {launched}, not {must}")
            out[route] = {"launches": launched, "seconds": sec}
            del step
            torch.cuda.empty_cache()
    finally:
        set_policy(**saved)
    del state, start
    mp, gp, names = res["plain"]
    failed = []
    bounds = {"v2": (V2_F32_LOSS_TOL, V2_F32_NORM_RTOL, V2_F32_LEAF_RTOL),
              "v1": (F32_LOSS_TOL, F32_NORM_RTOL, F32_LEAF_RTOL)}
    for route in V2_F32_ROUTES:
        mk, gk, _ = res[route]
        r = out[route]
        for key in ("d_loss", "g_loss"):
            r[key] = abs(mk[key] - mp[key])
        for key in ("d_grad_norm", "g_grad_norm"):
            r[key] = abs(mk[key] - mp[key]) / mp[key]
        rel = {name: (a - b_).abs().max().item() / max(b_.abs().max().item(), 1e-30)
               for name, a, b_ in zip(names, gk, gp)}
        worst = max(rel, key=lambda k: rel[k] if math.isfinite(rel[k]) else math.inf)
        r["worst_leaf_rel"], r["worst_leaf"] = rel[worst], worst
        for which, (loss_tol, norm_rtol, leaf_rtol) in bounds.items():
            r[f"misses_{which}"] = (
                [k for k in ("d_loss", "g_loss") if not r[k] <= loss_tol]
                + [k for k in ("d_grad_norm", "g_grad_norm") if not r[k] <= norm_rtol]
                + (["a gradient leaf"] if not rel[worst] <= leaf_rtol else []))
        misses = r["misses_v2"]
        print(f"{tag} {route}: losses |d| {r['d_loss']:.3g}, {r['g_loss']:.3g} (tolerance "
              f"{V2_F32_LOSS_TOL}); norms relative {r['d_grad_norm']:.3g}, "
              f"{r['g_grad_norm']:.3g} ({V2_F32_NORM_RTOL}); worst leaf max|d| / max|plain| "
              f"{rel[worst]:.4g} at {worst} ({V2_F32_LEAF_RTOL}); misses {misses or 'nothing'};"
              f" of the v1 f32 bounds {r['misses_v1'] or 'nothing'}")
        if route in V2_F32_CONTROLS:
            if not misses:
                failed.append(f"{route}: the f32 bounds do not see kernels that round through "
                              "bf16")
        elif misses:
            failed.append(f"{route}: " + ", ".join(misses) + " differ from the plain route")
    if failed:
        raise AssertionError(f"{tag} " + "; ".join(failed))
    return out


def _f32_fit(tag: str, cfg, run_dir: str, per_step: dict, steps: int) -> tuple:
    """``cfg`` (f32) through Trainer.fit: 1 eager warm-up step, 2 eager steps
    timed, a warm-up epoch of ``steps`` (the capture), then a timed epoch of
    captured steps after _settle; launches a step held to ``per_step`` and
    free of bf16 LayerNorm and flash launches.  Returns (trainer, record)."""
    import torch

    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.train.step import host_metrics
    from vitgan_tpu_torch.train.trainer import Trainer

    m = cfg.v2
    t0 = time.perf_counter()
    trainer = Trainer(cfg, run_dir=run_dir, device="cuda")
    setup = time.perf_counter() - t0
    st = trainer.state
    host_metrics(trainer.train_step(st, trainer.real_batch(trainer.batches()[0])))
    eager_ms = _eager_step_ms(trainer, 2)
    grid = _grid_launches(trainer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.fit(epochs=1)  # the warm-up epoch: its first step eager, then captured
    _settle()
    torch.cuda.synchronize()
    build.reset_launches()
    # --- the v2 f32 path ---
    means = trainer.fit()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    # --- end of the v2 f32 path ---
    peak = torch.cuda.max_memory_allocated()
    ms = 1e3 * m.batch_size / means["images_per_sec"]
    per = _check_fit_launches(tag, launches, per_step, steps, grid)
    _no_bf16_launch(tag, per)
    if not all(math.isfinite(means[k]) for k in ("d_loss", "g_loss", "d_grad_norm",
                                                 "g_grad_norm")):
        raise AssertionError(f"{tag} non-finite train metrics: {means}")
    print(f"{tag} {_smi()}: {m.image_size} px, E {m.embed_dim}, depth {m.depth}, batch "
          f"{m.batch_size}, {cfg.runtime.compute_dtype}, megablock {cfg.runtime.megablock}, "
          f"megablock_bwd {cfg.runtime.megablock_bwd}, remat {cfg.runtime.remat!r}, dropout "
          f"{m.dropout}: {steps} captured steps by Trainer.fit {ms:.2f} ms/step, the eager step "
          f"{eager_ms:.2f} ms, peak {peak / 2**30:.2f} GiB; set up in {setup:.1f} s; launches a "
          f"step {per_step}")
    return trainer, {"card": _smi(), "ms_per_step": ms, "eager_ms_per_step": eager_ms,
                     "peak_allocated_bytes": peak, "steps": steps, "means": means,
                     "launches": {k: v for k, v in per.items() if v}}


def p4_f32_steps(trainer, n: int = P4_F32_STEPS) -> dict:
    """[v2 f32] highres256p4: ``trainer``'s (the [highres256p4] phase's)
    state and device-resident data under its preset with
    runtime.compute_dtype=float32, without Trainer.fit: one eager warm-up
    step, one eager step timed, a captured function of ``n`` steps (its
    first step eager, then captured) called once, then again: ``n`` replays
    timed (host clock to a sync), their launches a step held to
    V2_F32_KERNELS["p4"] (the standard path) and free of bf16 LayerNorm and
    flash launches.  The trainer's state goes on from where it is."""
    import torch

    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.ops.policy import apply_from_runtime, get_policy, set_policy
    from vitgan_tpu_torch.train.sample import latent_block
    from vitgan_tpu_torch.train.step import (host_metrics, make_device_data_train_fn,
                                             make_train_step)

    tag, per_step = "[v2 f32 highres256p4]", V2_F32_KERNELS["p4"]
    cfg = C.replace(trainer.cfg, **V2_F32)
    m, st, order = cfg.v2, trainer.state, trainer.batches()
    saved = get_policy()
    try:
        apply_from_runtime(cfg.runtime)
        step = make_train_step(trainer.gan, cfg)
        host_metrics(step(st, trainer.real_batch(order[0])))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host_metrics(step(st, trainer.real_batch(order[1])))
        eager_ms = 1e3 * (time.perf_counter() - t0)
        fn = make_device_data_train_fn(trainer.gan, cfg, n)
        lat = latent_block(trainer.gan, st.seed, st.step, n, m.batch_size,
                           max(1, getattr(m, "disc_steps", 1)))
        idx = order[:n]  # an epoch holds P4_STEPS batches
        torch.cuda.reset_peak_memory_stats()
        fn(st, trainer.dataset, idx, lat)  # the first step eager, its capture
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        got = fn(st, trainer.dataset, idx, lat)  # n replays
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / n
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
    finally:
        set_policy(**saved)
    metrics = {k: v.float().cpu().tolist() for k, v in got.items()}  # a value a step
    peak = torch.cuda.max_memory_allocated()
    want = {k: v * n for k, v in per_step.items()}
    if launches != want:
        raise AssertionError(f"{tag} {n} captured steps launched {launches}, not {want}")
    _no_bf16_launch(tag, launches)
    if not all(math.isfinite(x) for v in metrics.values() for x in v):
        raise AssertionError(f"{tag} non-finite train metrics: {metrics}")
    print(f"{tag} {_smi()}: {m.image_size} px at patch {m.patch_size}, E {m.embed_dim}, depth "
          f"{m.depth}, batch {m.batch_size}, {cfg.runtime.compute_dtype}, remat "
          f"{cfg.runtime.remat!r}, dropout {m.dropout}: {n} captured steps {ms:.2f} ms a step "
          f"(host clock), the eager step {eager_ms:.2f} ms, peak {peak / 2**30:.2f} GiB; "
          f"launches a step {per_step}")
    del fn
    torch.cuda.empty_cache()
    return {"card": _smi(), "ms_per_step": ms, "eager_ms_per_step": eager_ms,
            "peak_allocated_bytes": peak, "steps": n, "metrics": metrics,
            "launches_per_step": per_step}


def v2_f32_path(work: str, bf16_run_dir: "str | None" = None) -> dict:
    """[v2 f32]: the v2 presets with runtime.compute_dtype=float32 under
    use_pallas=auto.  highres128 served at batch 64 through the megablock's
    f32 forward (launches a call held to V2_F32_SERVE a block, no bf16
    LayerNorm or flash launch), beside the same weights served in bf16
    (``bf16_run_dir``: [serve]'s run directory, else one written here); a
    DeiT-B-width deit64 serving call (E 768, the batch-64 serving function
    on the card); highres128 at its preset (megablock=auto, the saved
    backward, dropout 0.1, remat attn) trained through Trainer.fit (launches
    a step V2_F32_KERNELS["saved"], no bf16 kernel, no recompute backward),
    then captured against eager (bit-equal); deit64 at its preset, one
    captured step on the saved route; highres128 under megablock=on,
    megablock_bwd=recompute (launches a step V2_F32_KERNELS["recompute"]),
    captured against eager; one dropout-0 step on each route against
    use_pallas=never in f32 (compare_v2_f32_routes, with the bf16-fed
    controls).  highres256p4's f32 steps run later, on [highres256p4]'s
    trainer (p4_f32_steps)."""
    from vitgan_tpu_torch.ops.policy import get_policy, set_policy

    saved = get_policy()  # the fits below set the routing from their configs
    try:
        return _v2_f32_phases(work, bf16_run_dir)
    finally:
        set_policy(**saved)


def _v2_f32_phases(work: str, bf16_run_dir) -> dict:
    """v2_f32_path's phases, in its order."""
    from vitgan_tpu_torch import config as C

    out = {"card": _smi()}
    out["serve"] = _serve_f32("[v2 f32 serve]", C.replace(C.highres_config(128), **V2_F32),
                              os.path.join(work, "serve_f32"))
    write = bf16_run_dir is None  # [serve]'s run directory holds the same weights in bf16
    out["serve_bf16"] = _serve_f32("[v2 f32 serve]", C.highres_config(128),
                                   bf16_run_dir or os.path.join(work, "serve_bf16"), write=write)
    out["serve_deit_b"] = _sample_call_f32("[v2 f32 serve DeiT-B width]", C.replace(
        C.deit64_config(), **{**DEIT_B, **V2_F32}))
    out["train_saved"] = _saved_f32_fit(os.path.join(work, "train_saved"))
    out["deit64"] = _deit64_f32_step(os.path.join(work, "deit64"))
    cfg = C.replace(C.highres_config(128), **_fit_over({
        **V2_F32, "runtime.megablock": "on", "runtime.megablock_bwd": "recompute",
        "data.dataset": "synthetic", "data.synthetic_samples": 256, "run.epochs": 2,
        "run.steps_per_epoch": V2_F32_STEPS}))
    trainer, out["train_recompute"] = _f32_fit("[v2 f32 train]", cfg,
                                               os.path.join(work, "train"),
                                               V2_F32_KERNELS["recompute"], V2_F32_STEPS)
    capture = captured_vs_eager(cfg, 2, "highres128 f32 megablock=on/recompute",
                                trainer=trainer)
    if not capture["bit_equal"]:
        raise AssertionError("[v2 f32] the captured steps are not bit-equal to eager ones")
    out["train_recompute"]["captured_vs_eager"] = capture
    trainer.metrics.close()  # its writer thread, before the caller removes the run directory
    del trainer
    out["routes"] = compare_v2_f32_routes()
    return out


def _saved_f32_fit(run_dir: str) -> dict:
    """highres128 at its preset with only runtime.compute_dtype=float32
    (megablock=auto, megablock_bwd=saved, dropout 0.1, remat attn, batch 32,
    depth 12) through Trainer.fit (_f32_fit: launches a step held to
    V2_F32_KERNELS["saved"], none of BF16_KERNELS), with the recompute
    Function's backward counted (it must not run); then V2_F32_STEPS - 1
    captured steps against as many eager ones, bit-equal; then the captured
    step's device time by kernel group (train_breakdown)."""
    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.ops import fused_block as FB

    cfg = C.replace(C.highres_config(128), **_fit_over({
        **V2_F32, "data.dataset": "synthetic", "data.synthetic_samples": 256, "run.epochs": 2,
        "run.steps_per_epoch": V2_F32_STEPS}))
    recomputed = []
    backward = FB._RecomputeBlock.backward

    def counted(ctx, g):
        recomputed.append(1)
        return backward(ctx, g)

    FB._RecomputeBlock.backward = staticmethod(counted)
    try:
        trainer, rec = _f32_fit("[v2 f32 train saved]", cfg, run_dir, V2_F32_KERNELS["saved"],
                                V2_F32_STEPS)
        capture = captured_vs_eager(cfg, 2, "highres128 f32 at its preset (saved)",
                                    trainer=trainer)
    finally:
        FB._RecomputeBlock.backward = staticmethod(backward)
    print(f"[v2 f32 train saved] _RecomputeBlock.backward calls: {len(recomputed)}")
    if recomputed:
        raise AssertionError("[v2 f32] the saved route ran the recompute backward")
    if not capture["bit_equal"]:
        raise AssertionError("[v2 f32] the saved route's captured steps are not bit-equal to "
                             "eager ones")
    rec["captured_vs_eager"] = capture
    print("[v2 f32 train saved] where the f32 step's device time goes:")
    rec["breakdown"] = train_breakdown(trainer, rec["ms_per_step"], recompute=False)
    rec["breakdown"]["kmajor_copies"] = kmajor_copy_ms(cfg, V2_F32_KERNELS["saved"])
    trainer.metrics.close()  # its writer thread, before the caller removes the run directory
    del trainer
    return rec


def kmajor_copy_ms(cfg, per_step: dict) -> dict:
    """The K-major weight copies that the f32 LayerNorm entries' wrappers make
    in each call (fused_mlp.kmajor, fused_block._qkv_weight_kmajor), a step:
    their count from the launches a step ``per_step`` (an LN -> fc1 launch
    copies w1, as many fc2 linear launches w2, the other linear launches
    wout, an LN -> qkv launch wqkv), each copy's device time alone at the
    configuration's widths (the profiler over 50 calls; CUDA events around
    such small calls time the host).  Returns {"copies_per_step",
    "device_ms_each", "ms_per_step"}, None where not measured."""
    import torch

    from vitgan_tpu_torch.ops import fused_block as FB
    from vitgan_tpu_torch.ops import fused_mlp as FM

    v2 = cfg.v2
    e, hidden, heads = v2.embed_dim, v2.embed_dim * v2.mlp_ratio, v2.num_heads
    fc1, linear, qkv = (per_step.get(k, 0) for k in F32_LN_KERNELS)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 29)
    copies = {"w1": (FM.kmajor, (e, hidden), fc1), "w2": (FM.kmajor, (hidden, e), fc1),
              "wout": (FM.kmajor, (e, e), linear - fc1),
              "wqkv": (FB._qkv_weight_kmajor, (3, heads, e, e // heads), qkv)}
    out = {"copies_per_step": {}, "device_ms_each": {}, "ms_per_step": 0.0}
    for name, (copy, shape, count) in copies.items():
        w = torch.randn(shape, generator=gen, device="cuda")
        ms, _ = _device_ms(lambda: copy(w), 50, ("",))  # "": every device op of the call
        out["copies_per_step"][name] = count
        out["device_ms_each"][name] = ms
        out["ms_per_step"] = None if ms is None or out["ms_per_step"] is None else \
            out["ms_per_step"] + count * ms
    step = out["ms_per_step"]
    print(f"[breakdown] K-major weight copies of the f32 LayerNorm entries: "
          f"{sum(out['copies_per_step'].values())} a step ({out['copies_per_step']}), "
          f"{_smi()}: device {'not measured' if step is None else f'{step:.3f} ms'} a step "
          f"(each alone: {out['device_ms_each']})")
    return out


def _deit64_f32_step(run_dir: str) -> dict:
    """deit64 at its preset in f32 (megablock=auto on the saved route, 256
    tokens in G and 257 in D: ragged rows; dropout 0.1, remat never) through
    _f32_fit with one step an epoch: one captured step, its launches held to
    V2_F32_KERNELS["deit64"]."""
    from vitgan_tpu_torch import config as C

    cfg = C.replace(C.deit64_config(), **_fit_over({
        **V2_F32, "data.dataset": "synthetic", "data.synthetic_samples": 256, "run.epochs": 2,
        "run.steps_per_epoch": 1}))
    trainer, rec = _f32_fit("[v2 f32 deit64]", cfg, run_dir, V2_F32_KERNELS["deit64"], 1)
    trainer.metrics.close()  # its writer thread, before the caller removes the run directory
    del trainer
    return rec


# [eval]: the extractors on the card against the same module on the CPU, both
# in f32 (models/inception.full_f32 keeps TF32 off): |card - CPU| <= TOL *
# max(1, max|CPU|); the on-device FID against the host's FeatureStats on the
# same features within FID_RTOL, FID_ATOL.
INCEPTION_TOL, RANDOM_CONV_TOL = 1e-3, 1e-4
# With the process's TF32 switches on, the extractor still holds to the CPU
# within TF32_GUARD_TOL * max(1, max|CPU|): a bar TF32 itself misses (on the
# H100 its features drift to ~5e-4 of max|CPU|, true f32 to ~4e-7).
TF32_GUARD_TOL = 1e-4
FID_RTOL, FID_ATOL = 1e-3, 1e-4
EVAL_KEYS = ("fid", "kid_mean", "kid_std", "precision", "recall", "inception_score_mean",
             "inception_score_std")


def _feature_err(got, want, tol: float, what: str) -> float:
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{what}: {got.shape} card against {want.shape} CPU, or non-finite")
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    bar = tol * max(1.0, scale)
    print(f"  {what}: max_abs_err {err:.6g} (tolerance {bar:.6g}, max|CPU| {scale:.6g})")
    if not err <= bar:
        raise AssertionError(f"{what}: the card disagrees with the CPU")
    return err


def _fid_close(got: float, want: float, what: str) -> None:
    print(f"  {what}: {got!r} against {want!r} (rtol {FID_RTOL}, atol {FID_ATOL})")
    if not abs(got - want) <= FID_ATOL + FID_RTOL * abs(want):
        raise AssertionError(f"{what}: {got} against {want}")


def eval_path(work: str) -> dict:
    """[eval]: (a) the port's InceptionV3 at 299 px with random_torch_state_dict(0)
    weights through $INCEPTION_WEIGHTS (the `inception` route a user takes)
    on 8 uint8 images at 128 px, features and logits against the same module
    on the CPU, and its forward's time at batch 64; (b) the random-conv
    extractor against the CPU; (c) the on-device FID's moments against the
    host's FeatureStats on the same Inception features, 4 batches of 32;
    (d) highres128 through Trainer at batch 32 on a 2,560-image synthetic
    dataset, 2 epochs of a few captured steps with FID every epoch at the
    preset's 2,560 samples: both FIDs finite, the best checkpoint and
    generator_best.pt written, the launches of one evaluate_fid equal to
    n_batches serving calls', its seconds split into generator, features and
    the host's Frechet math; `cli generate --best`; (e) `cli eval --best`."""
    import contextlib

    import numpy as np
    import torch

    from vitgan_tpu_torch import cli
    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.data.datasets import synthetic_dataset
    from vitgan_tpu_torch.models import inception as I
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.train import fid as F
    from vitgan_tpu_torch.train.sample import latent_rng, make_sample_fn
    from vitgan_tpu_torch.train.trainer import Trainer

    tag, smi, out = "[eval]", _smi(), {}
    os.makedirs(work, exist_ok=True)
    weights = os.path.join(work, "fid_inception.npz")
    params = I.convert_torch_state_dict(I.random_torch_state_dict(0))
    I.save_params(weights, params)
    saved_env = os.environ.get("INCEPTION_WEIGHTS")
    os.environ["INCEPTION_WEIGHTS"] = weights
    try:
        ex = F.make_feature_extractor("inception", 3, "cuda")
        if ex.name != "inception" or ex.logits_fn is None or ex.device.type != "cuda":
            raise AssertionError(f"`inception` took {ex.name} on {ex.device}")
        cpu = I.InceptionV3.from_params(params, "cpu")
        rng = np.random.default_rng(SEED)
        imgs = rng.integers(0, 256, (8, 128, 128, 3), dtype=np.uint8)
        print(f"{tag} (a) InceptionV3 at 299 px, random_torch_state_dict(0) through "
              "$INCEPTION_WEIGHTS, 8 uint8 images at 128 px: card against CPU, f32")
        x = torch.from_numpy(imgs)
        want = I.inception_features(cpu, x).numpy()
        out["inception_features_err"] = _feature_err(ex(imgs), want, INCEPTION_TOL, "features")
        out["inception_logits_err"] = _feature_err(
            ex.logits_fn(imgs), I.inception_logits(cpu, x).numpy(), INCEPTION_TOL, "logits")
        prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        try:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
            print(f"{tag} (a) with the process's TF32 switches on:")
            out["inception_tf32_switches_on_err"] = _feature_err(
                ex(imgs), want, TF32_GUARD_TOL, "features (full_f32 in scope)")
            with torch.inference_mode():  # the network alone, no full_f32
                card = I.InceptionV3.from_params(params, "cuda")
                tf32 = card(I.preprocess(x.cuda())).cpu().numpy()
                del card
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        out["inception_tf32_err"] = err = float(np.abs(tf32 - want).max())
        print(f"  the same forward in TF32, for the record: max_abs_err {err:.6g} "
              f"({err / np.abs(want).max():.3g} of max|CPU|)")
        del cpu
        x64 = torch.from_numpy(rng.integers(0, 256, (64, 128, 128, 3), dtype=np.uint8)).cuda()
        out["inception_ms_batch64"] = _time_ms(lambda: ex.feature_fn(x64), 10)
        print(f"{tag} (a) Inception forward at batch 64 (128 -> 299 px, f32): "
              f"{out['inception_ms_batch64']:.3f} ms; {smi}")
        rc, rc_cpu = (F.make_feature_extractor("random_conv", 3, d) for d in ("cuda", "cpu"))
        imgs64 = x64.cpu().numpy()
        print(f"{tag} (b) random_conv, 64 images at 128 px: card against CPU, f32")
        out["random_conv_err"] = _feature_err(rc(imgs64), rc_cpu(imgs64), RANDOM_CONV_TOL,
                                              "features")
        out["random_conv_ms_batch64"] = _time_ms(lambda: rc.feature_fn(x64), 10)
        print(f"{tag} (b) random_conv forward at batch 64: {out['random_conv_ms_batch64']:.3f} "
              f"ms; {smi}")

        # (c) the on-device moments against the host's, on the same features
        b, n_batches = 32, 4
        dataset, _ = synthetic_dataset(256, 128, 3, seed=SEED)
        fake = rng.uniform(-1, 1, (b, 128, 128, 3)).astype(np.float32)
        real_idx = rng.choice(len(dataset), size=(n_batches, b), replace=False)

        class Fixed(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.imgs = torch.from_numpy(fake).cuda()

            def forward(self, z):
                return self.imgs[: z.shape[0]]

        class Bundle:
            def sample_latent(self, r, n):
                return torch.from_numpy(r.standard_normal((n, 4), np.float32))

        fid_fn = F.make_on_device_fid(Bundle(), C.highres_config(128), ex.feature_fn, b,
                                      n_batches, ex.feature_dim)
        got = fid_fn(Fixed(), torch.from_numpy(dataset).cuda(), real_idx, 0)
        rs, fs = F.FeatureStats(ex.feature_dim), F.FeatureStats(ex.feature_dim)
        fake_feats = ex(F.to_uint8(fake))
        for row in real_idx:
            rs.update(ex(dataset[row]))
            fs.update(fake_feats)
        print(f"{tag} (c) on-device FID moments against FeatureStats, {n_batches} batches of {b}")
        _fid_close(got, F.frechet_distance(*rs.moments(), *fs.moments()), "FID")
        out["on_device_fid"] = got
        del ex, rc, rc_cpu, x64, fid_fn
        torch.cuda.empty_cache()

        # (d) highres128 through Trainer with FID every epoch
        run_dir, steps = os.path.join(work, "run"), 3
        cfg = C.replace(C.highres_config(128), **{
            "data.dataset": "synthetic", "data.synthetic_samples": 2560, "run.epochs": 2,
            "run.steps_per_epoch": steps, "run.log_every_steps": 0,
            "run.sample_grid_every_epochs": 0, "run.keep_checkpoints": 1,
            "run.fid_every_epochs": 1})
        m, num = cfg.v2, cfg.run.fid_num_samples
        t0 = time.perf_counter()
        trainer = Trainer(cfg, run_dir=run_dir, device="cuda", fid_extractor="inception")
        means = trainer.fit()
        fit_s = time.perf_counter() - t0
        with open(os.path.join(trainer.dirs.logs, "scalars.jsonl")) as f:
            scalars = [json.loads(line) for line in f]
        fids = [s["value"] for s in scalars if s["tag"] == "eval/fid"]
        fid_s = [s["value"] for s in scalars if s["tag"] == "eval/fid_seconds"]
        print(f"{tag} (d) highres128 at batch {m.batch_size}, depth {m.depth}, {num} FID "
              f"samples a side, extractor {trainer.extractor.name}: 2 epochs of {steps} steps "
              f"in {fit_s:.1f} s; FID {fids}, seconds {fid_s} (the first builds the extractor)")
        if len(fids) != 2 or not all(math.isfinite(v) and v >= 0 for v in fids):
            raise AssertionError(f"FIDs {fids}")
        for rel in ("checkpoints/best/state.pt", "checkpoints/best.json", "generator_best.pt"):
            if not os.path.exists(os.path.join(run_dir, rel)):
                raise AssertionError(f"fit wrote no {rel}")
        # one serving call's launches at the batch, then one evaluate_fid's
        g = trainer._sampling_generator()
        z = trainer.gan.sample_latent(latent_rng(SEED, 0), m.batch_size)
        make_sample_fn(trainer.gan, cfg)(g, z)
        torch.cuda.synchronize()
        build.reset_launches()
        make_sample_fn(trainer.gan, cfg)(g, z)
        torch.cuda.synchronize()
        per_call = {k: v for k, v in build.LAUNCHES.items() if v}
        n_batches = num // m.batch_size
        spans = {}
        build.reset_launches()
        t0 = time.perf_counter()
        # --- the main path ---
        fid = trainer.evaluate_fid(spans=spans)
        torch.cuda.synchronize()
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        # --- end of the main path ---
        sec = time.perf_counter() - t0
        print(f"{tag} (d) one serving call at batch {m.batch_size} launches {per_call}; one "
              f"evaluate_fid ({n_batches} batches a side) {launches}")
        if not per_call or launches != {k: n_batches * v for k, v in per_call.items()}:
            raise AssertionError(f"evaluate_fid launched {launches}, expected {n_batches} x "
                                 f"{per_call}")
        _fid_close(fid, fids[-1], "evaluate_fid again at the fit's last step")
        print(f"{tag} (d) FID at {num} samples: {fid_s[-1]:.3f} s in fit; {sec:.3f} s with the "
              f"device synchronised around each part: generator {spans['generator']:.3f} s, "
              f"Inception features and moments {spans['features']:.3f} s, host Frechet/eigh "
              f"{spans['frechet']:.3f} s; {smi}")
        out.update({"fids": fids, "fid_seconds": fid_s, "fid_split_seconds": spans,
                    "fid_split_total_seconds": sec, "n_batches": n_batches,
                    "launches_per_serving_call": per_call, "launches": launches,
                    "means": means})
        del trainer, g
        torch.cuda.empty_cache()
        if cli.main(["generate", "--run-dir", run_dir, "--best", "--num-images", "16",
                     "--seed", "3"]) != 0:
            raise AssertionError("cli generate --best failed")
        if np.load(os.path.join(run_dir, "test", "noise.npy")).shape != (16, m.latent_dim):
            raise AssertionError("cli generate --best wrote no latents")
        print(f"{tag} (d) `cli generate --best` sampled the best generator")

        # (e) cli eval --best
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["eval", "--run-dir", run_dir, "--best", "--extractor", "inception",
                           "--kid-subsets", "20", "--seed", "0"])
        eval_s = time.perf_counter() - t0
        res = json.loads(buf.getvalue().strip().splitlines()[-1])
        print(f"{tag} (e) `cli eval --best` in {eval_s:.1f} s: "
              f"{json.dumps({k: res.get(k) for k in (*EVAL_KEYS, 'num_real', 'ckpt_step')})}")
        if rc != 0 or not all(math.isfinite(res.get(k, math.nan)) for k in EVAL_KEYS):
            raise AssertionError(f"cli eval --best: rc {rc}, {res}")
        out["cli_eval"] = {k: res[k] for k in (*EVAL_KEYS, "num_real", "num_fake",
                                                 "ckpt_step")}
        out["cli_eval_seconds"] = eval_s
    finally:
        if saved_env is None:
            os.environ.pop("INCEPTION_WEIGHTS", None)
        else:
            os.environ["INCEPTION_WEIGHTS"] = saved_env
    return out


DATA_STEPS = 8  # run.steps_per_epoch of each [data] training epoch


def _write_cifar(root: str, n_per_batch: int, archive: bool = False) -> float:
    """CIFAR-10's python archive from seeded numpy: five ``data_batch_*``
    pickles of ``n_per_batch`` images and ``test_batch``, each the dict the
    real files hold (b"data" (n, 3072) uint8 in CHW order, b"labels" a list of
    ints); with ``archive`` only ``cifar-10-python.tar.gz``.  Seconds taken."""
    import pickle
    import tarfile

    import numpy as np

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({b"batch_label": name.encode(),
                         b"data": rng.integers(0, 256, (n_per_batch, 3072), dtype=np.uint8),
                         b"labels": rng.integers(0, 10, n_per_batch).tolist()}, f, protocol=2)
    if archive:
        with tarfile.open(os.path.join(root, "cifar-10-python.tar.gz"), "w:gz",
                          compresslevel=1) as tf:
            tf.add(d, arcname="cifar-10-batches-py")
        shutil.rmtree(d)
    return time.perf_counter() - t0


def _write_mnist(root: str) -> float:
    """MNIST's IDX files from seeded numpy: 60,000 training digits (plain
    files) and 10,000 test digits (gzipped).  Seconds taken."""
    import gzip
    import struct

    import numpy as np

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 1)
    os.makedirs(root, exist_ok=True)
    for prefix, n, opener, ext in (("train", 60000, open, ""), ("t10k", 10000, gzip.open, ".gz")):
        x = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
        y = rng.integers(0, 10, n).astype(np.uint8)
        with opener(os.path.join(root, f"{prefix}-images-idx3-ubyte{ext}"), "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28) + x.tobytes())
        with opener(os.path.join(root, f"{prefix}-labels-idx1-ubyte{ext}"), "wb") as f:
            f.write(struct.pack(">II", 2049, n) + y.tobytes())
    return time.perf_counter() - t0


def _profiled_epoch(trainer) -> dict:
    """One epoch of the trainer's device calls (fit's loop body, without its
    epilogue) under torch.profiler: wall ms a step, the kernels' device time
    a step (busy) and each kind of copy's (memcpy and memset, by the
    profiler's name: the pipeline's batches are "Memcpy HtoD (Pinned ->
    Device)")."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vitgan_tpu_torch.train.step import host_metrics

    _settle()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for m, n_images in trainer._epoch_calls():
            steps += n_images // trainer.cfg.model.batch_size
        host_metrics({"d": m["d_loss"].mean()})
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / steps
    busy, copies = 0.0, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = e.self_device_time_total / 1e3 / steps
            if e.key.startswith(("Memcpy", "Memset")):
                copies[e.key] = copies.get(e.key, 0.0) + t
            else:
                busy += t
    return {"steps": steps, "wall_ms": wall, "busy_ms": busy or None, "copy_ms": copies}


def _data_fit(tag: str, cfg, run_dir: str) -> tuple:
    """highres128 through Trainer on ``cfg``'s route: a warm-up epoch (the
    capture), a timed epoch by fit (launches counted), a profiled epoch.
    Returns (trainer, record, the timed epoch's launches, the orders the
    pipeline drew, the state before the first step)."""
    import torch

    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    trainer = Trainer(cfg, run_dir=run_dir, device="cuda")
    setup = time.perf_counter() - t0
    start = _flat_state(trainer.state)
    orders, draw = [], trainer.pipeline._epoch_order

    def record():
        orders.append(draw())
        return orders[-1]

    trainer.pipeline._epoch_order = record
    grid = _grid_launches(trainer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.fit(epochs=1)  # the warm-up epoch: its first step eager, then captured
    warm = time.perf_counter() - t0
    _settle()
    torch.cuda.synchronize()
    build.reset_launches()
    # --- the main path ---
    means = trainer.fit(epochs=2)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    # --- end of the main path ---
    stats = trainer.pipeline.stats
    peak = torch.cuda.max_memory_allocated()
    per_step = _check_fit_launches(tag, launches, train_kernels("auto", cfg.runtime.remat),
                                   DATA_STEPS, grid)
    ms = 1e3 * cfg.model.batch_size / means["images_per_sec"]
    prof = _profiled_epoch(trainer)
    rec = {"route": trainer.route, "assembler": trainer.pipeline.assembler,
           "setup_s": setup, "warm_up_epoch_s": warm, "ms_per_step": ms,
           "img_per_s": means["images_per_sec"], "peak_allocated_bytes": peak,
           "profiled": prof,
           "idle_share": None if prof["busy_ms"] is None else 1 - prof["busy_ms"] / ms,
           "d_loss": means["d_loss"], "g_loss": means["g_loss"]}
    if trainer.route == "host":
        n = stats.batches
        rec["pipeline"] = {"batches": n, "assemble_ms_per_batch": 1e3 * stats.assemble_s / n,
                           "issue_ms_per_batch": 1e3 * stats.issue_s / n,
                           "waits": stats.waits, "wait_ms_total": 1e3 * stats.wait_s}
    print(f"{tag} set up in {setup:.1f} s (decode, resize, model), warm-up epoch {warm:.2f} s; "
          f"{DATA_STEPS} captured steps by fit: {ms:.3f} ms/step, peak "
          f"{peak / 2**30:.2f} GiB; profiled epoch: wall {prof['wall_ms']:.3f} ms/step, device "
          f"busy {prof['busy_ms']} ms/step, copies (ms/step) {prof['copy_ms']}; idle share "
          f"{rec['idle_share']}")
    if trainer.route == "host":
        print(f"{tag} pipeline ({trainer.pipeline.assembler}): {rec['pipeline']}")
    if not all(math.isfinite(means[k]) for k in ("d_loss", "g_loss")):
        raise AssertionError(f"{tag} non-finite train metrics: {means}")
    return trainer, rec, per_step, list(orders), start


def data_path(work: str) -> tuple:
    """[data]: CIFAR-10 and MNIST files written from seeded numpy, decoded and
    resized; highres128 at its defaults over the 50,000-image CIFAR-10 set at
    128 px (2.46 GB, over data.on_device_max_bytes) on the host route, then
    on the device route with the limit raised, both with augment_flip=False:
    the same orders, bit-equal batches, equal launches a step, their states
    compared; v1's partial batch; FID on the host route.  Returns (the
    record, the host route's launches over its timed epoch)."""
    import numpy as np
    import torch

    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.data import transforms as TR
    from vitgan_tpu_torch.data.datasets import load_cifar10, load_dataset
    from vitgan_tpu_torch.data.pipeline import normalize_to_unit
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.train.step import device_batch

    tag, smi = "[data]", _smi()
    out = {"card": smi}
    cifar, tar = os.path.join(work, "cifar10"), os.path.join(work, "cifar10_tar")
    small, mnist = os.path.join(work, "cifar10_5k"), os.path.join(work, "mnist")
    out["write_s"] = {"cifar10": _write_cifar(cifar, 10000),
                      "cifar10_tar_gz": _write_cifar(tar, 10000, archive=True),
                      "cifar10_5k": _write_cifar(small, 1000), "mnist": _write_mnist(mnist)}
    print(f"{tag} {smi}: wrote CIFAR-10 (5 x 10,000 + 10,000 images), its .tar.gz, a "
          f"5,000-image CIFAR set and MNIST (60,000 + 10,000), seconds {out['write_s']}")

    # Decode and resize.
    t0 = time.perf_counter()
    x32, y = load_cifar10(cifar)
    t_decode = time.perf_counter() - t0
    t0 = time.perf_counter()
    xa, ya = load_dataset("cifar10", root=tar, image_size=32)
    t_archive = time.perf_counter() - t0
    if xa.tobytes() != x32.tobytes() or ya.tobytes() != y.tobytes():
        raise AssertionError(f"{tag} the .tar.gz decodes to other bytes than the directory")
    del xa, ya
    before = dict(TR.RESIZES)
    t0 = time.perf_counter()
    x128 = TR.reference_transforms(x32, 128)
    t_resize = time.perf_counter() - t0
    if TR.RESIZES["native"] != before["native"] + 1 or TR.RESIZES["numpy"] != before["numpy"]:
        raise AssertionError(f"{tag} the resize did not take the native path: {TR.RESIZES}")
    sub = TR._resize_numpy(x32[:64], 128, 128)
    if sub.tobytes() != x128[:64].tobytes():
        raise AssertionError(f"{tag} the numpy resize differs from the native one")
    t0 = time.perf_counter()
    xm, _ = load_dataset("mnist", root=mnist, image_size=32)
    t_mnist = time.perf_counter() - t0
    if x128.shape != (50000, 128, 128, 3) or xm.shape != (60000, 32, 32, 3):
        raise AssertionError(f"{tag} shapes {x128.shape} {xm.shape}")
    out.update({"decode_s": t_decode, "archive_extract_decode_s": t_archive,
                "resize_32_to_128_s": t_resize, "mnist_decode_s": t_mnist,
                "dataset_bytes": x128.nbytes})
    print(f"{tag} {smi}: CIFAR-10 decoded in {t_decode:.2f} s (from the .tar.gz, extracted, "
          f"{t_archive:.2f} s, byte-equal), resized 32 -> 128 natively in {t_resize:.2f} s "
          f"({x128.nbytes} bytes; numpy bit-equal on 64 images), MNIST decoded in "
          f"{t_mnist:.2f} s")
    del x32, xm, x128

    # highres128 on the host route, then on the device route.
    base = C.highres_config(128)
    over = _fit_over({"data.data_dir": cifar, "run.epochs": 2,
                      "run.steps_per_epoch": DATA_STEPS, "run.fid_num_samples": 2560})
    cfg = C.replace(base, **over)
    if cfg.data.dataset != "cifar10" or cfg.data.augment_flip or \
            out["dataset_bytes"] <= cfg.data.on_device_max_bytes:
        raise AssertionError(f"{tag} the preset's data defaults changed: {cfg.data}")
    host_t, host, host_launch, host_orders, start = _data_fit(
        f"{tag} host route", cfg, os.path.join(work, "run_host"))
    if host["route"] != "host" or host["assembler"] != "native":
        raise AssertionError(f"{tag} highres128 over CIFAR-10 took the {host['route']} route "
                             f"with the {host['assembler']} assembler")
    host_state = _flat_state(host_t.state)

    # FID on the host route: reals from an epoch of the pipeline.
    host_t._extractor_name = "random_conv"
    host_t.extractor  # built outside the timing
    torch.cuda.synchronize()
    build.reset_launches()
    spans: dict = {}
    t0 = time.perf_counter()
    fid = host_t.evaluate_fid(spans=spans)
    fid_s = time.perf_counter() - t0
    fid_launches = {k: v for k, v in build.LAUNCHES.items() if v}
    calls = -(-cfg.run.fid_num_samples // cfg.model.batch_size)
    if not math.isfinite(fid) or fid_launches.get("flash_attn_fwd") != 12 * calls or \
            fid_launches.get("ln_qkv_fwd") != 12 * calls:
        raise AssertionError(f"{tag} host-route FID {fid}, launches {fid_launches}")
    host["fid"] = {"extractor": "random_conv", "samples": cfg.run.fid_num_samples, "fid": fid,
                   "seconds": fid_s, "split_s": spans, "launches": fid_launches}
    print(f"{tag} {smi}: host-route FID {fid:.4f} ({cfg.run.fid_num_samples} a side, random "
          f"conv) in {fid_s:.3f} s, split {spans}; launches {fid_launches} ({calls} serving "
          "calls)")
    pipe_images = host_t.pipeline.images
    del host_t
    torch.cuda.empty_cache()

    dev_cfg = C.replace(cfg, **{"data.on_device_max_bytes": 3 << 30})
    dev_t, dev, dev_launch, dev_orders, _ = _data_fit(
        f"{tag} device route", dev_cfg, os.path.join(work, "run_device"))
    if dev["route"] != "device":
        raise AssertionError(f"{tag} the raised limit did not take the device route")
    if len(host_orders) != len(dev_orders) or any(
            not np.array_equal(a, b) for a, b in zip(host_orders, dev_orders)):
        raise AssertionError(f"{tag} the two routes drew other orders")
    # Bit-equal batches: the host's assembly against the device's gather.
    order = dev_orders[1]
    b = cfg.model.batch_size
    for i in range(DATA_STEPS):
        idx = order[i * b:(i + 1) * b]
        host_x = torch.from_numpy(normalize_to_unit(pipe_images[idx])).cuda()
        dev_x = device_batch(dev_t.dataset, torch.from_numpy(idx).cuda(), False, None)
        if not torch.equal(host_x, dev_x):
            raise AssertionError(f"{tag} batch {i} differs between the routes")
    if host_launch != dev_launch:
        raise AssertionError(f"{tag} launches a step differ: host {host_launch}, device "
                             f"{dev_launch}")
    dev_state = _flat_state(dev_t.state)
    start = {k: start.get(k, torch.zeros_like(v)) for k, v in dev_state.items()}
    groups = _hold_states(f"{tag} host against device route", start, dev_state, host_state)
    bit_equal = all(r["bit_equal"] == r["leaves"] for r in groups.values())
    dev_t._extractor_name = "random_conv"
    dev_t.extractor
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev_fid = dev_t.evaluate_fid()
    dev_fid_s = time.perf_counter() - t0
    ratio = host["ms_per_step"] / dev["ms_per_step"]
    out.update({"host_route": host, "device_route": dev, "host_to_device_step_ratio": ratio,
                "launches_per_step": {k: v / DATA_STEPS for k, v in host_launch.items() if v},
                "states_bit_equal": bit_equal, "state_groups": groups,
                "device_route_fid": dev_fid, "device_route_fid_s": dev_fid_s})
    states = ("bit-equal" if bit_equal
              else "NOT bit-equal (within the captured-against-eager bounds)")
    print(f"{tag} {smi}: highres128 host route {host['ms_per_step']:.3f} ms/step against the "
          f"device route's {dev['ms_per_step']:.3f} (ratio {ratio:.4f}); the same "
          f"{len(dev_orders)} orders, {DATA_STEPS} batches bit-equal, equal launches a step; "
          f"after {3 * DATA_STEPS} steps the states are {states}; device-route FID "
          f"{dev_fid:.4f} in {dev_fid_s:.3f} s")
    del dev_t
    torch.cuda.empty_cache()
    out["v1_partial"] = _v1_partial_batch(small, os.path.join(work, "run_v1"), tag, smi)
    return out, host_launch


def _v1_partial_batch(root: str, run_dir: str, tag: str, smi: str) -> dict:
    """v1 at its reference defaults with drop_last=False over a 5,000-image
    CIFAR-format set: 39 batches of 128 and one of 8 on the host route, one
    epoch that trains all 5,000 images."""
    import torch

    from vitgan_tpu_torch.train.trainer import Trainer

    cfg = _v1_cfg(**_fit_over({"data.dataset": "cifar10", "data.data_dir": root,
                               "data.drop_last": False, "run.epochs": 1}))
    trainer = Trainer(cfg, run_dir=run_dir, device="cuda")
    if trainer.route != "host" or trainer.pipeline.assembler != "native":
        raise AssertionError(f"{tag} v1 partial batch: {trainer.route} route, "
                             f"{trainer.pipeline.assembler}")
    sizes, epoch = [], trainer.pipeline.epoch

    def counting(max_batches=None):
        for x, y_ in epoch(max_batches):
            sizes.append(x.shape[0])
            yield x, y_

    trainer.pipeline.epoch = counting
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    means = trainer.fit()
    sec = time.perf_counter() - t0
    graphs = {n: len(fn.graphs) for n, fn in trainer._host_step_fns.items()}
    if sum(sizes) != 5000 or sizes[-1] != 8 or len(sizes) != 40 or \
            trainer.state.step != 40 or sorted(graphs) != [8, 128]:
        raise AssertionError(f"{tag} v1 partial batch: batches {sizes}, step "
                             f"{trainer.state.step}, graphs {graphs}")
    if not math.isfinite(means["d_loss"]):
        raise AssertionError(f"{tag} v1 partial batch: {means}")
    print(f"{tag} {smi}: v1 defaults, drop_last=False over 5,000 images: 39 x 128 + 1 x 8 "
          f"trained in one epoch of {sec:.2f} s (with its captures and the epilogue), "
          f"{means['images_per_sec']:.1f} img/s; graphs by batch size {graphs}")
    del trainer
    torch.cuda.empty_cache()
    return {"batches": len(sizes), "images": sum(sizes), "last_batch": sizes[-1],
            "epoch_s": sec, "img_per_s": means["images_per_sec"], "graphs": graphs}


# --- phases 22-25: double backward, int8 serving, reference checkpoints, baselines ---

# [double backward]: a v2 model at highres128's widths on 32 px images at patch 4
# (64 tokens, 65 in D), batch 64, dropout 0.1, bce, R1 every second step.
R1_OVER = {"v2.image_size": 32, "v2.patch_size": 4, "v2.batch_size": 64, "v2.r1_gamma": 10.0,
           "v2.r1_interval": 2}
R1_ROUTES = (("megablock_off", {"runtime.megablock": "off"}),
             ("megablock_on_recompute", {"runtime.megablock": "on",
                                         "runtime.megablock_bwd": "recompute"}))
# The kernels each route must launch in every block of every forward (G, D on
# [real; fake], the R1 forward of D on R1 steps, the G update's D forward), and
# none of the backward kernels: the recompute Functions differentiate their
# plain versions, once and twice.
R1_KERNELS = {"megablock_off": {"ln_mlp_fwd": 1, "ln_mlp_fc1": 1, "ln_mlp_linear": 1},
              "megablock_on_recompute": {"ln_qkv_fwd": 1, "flash_attn_fwd": 1,
                                         "ln_mlp_train_fwd": 1, "ln_mlp_fc1": 1,
                                         "ln_mlp_linear": 2}}


def _r1_cfg(route_over: dict, **extra):
    from vitgan_tpu_torch import config as C

    return C.replace(C.highres_config(128), **_fit_over({
        "data.dataset": "synthetic", "data.synthetic_samples": 512, **R1_OVER, **route_over,
        **extra}))


def _r1_block_forwards(label: str, cfg, with_r1: bool) -> int:
    """Block forwards a step runs on an R1 route: G, D on [real; fake], the G
    update's D and on R1 steps D's R1 forward; under runtime.remat the
    megablock's forward once more for each (R1's twice: its double backward
    re-runs the block again), the LN->MLP forward not (remat_extra)."""
    depth = cfg.v2.depth
    again = int(label != "megablock_off" and remat_name(cfg.runtime.remat) != "never")
    return depth * 3 * (1 + again) + (depth * (1 + 2 * again) if with_r1 else 0)


def _r1_route(label: str, route_over: dict, run_dir: str) -> tuple:
    """Eager and captured steps of one route, each kind (with and without R1)
    timed apart: 2 eager warm-up steps, 4 eager steps timed, 2 captured calls
    of one step (the two captures), 6 replays timed; launches a step by kind."""
    import torch

    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.train.step import host_metrics, make_device_data_train_fn
    from vitgan_tpu_torch.train.trainer import Trainer

    tag = f"[double backward] {label}"
    cfg = _r1_cfg(route_over)
    trainer = Trainer(cfg, run_dir=run_dir, device="cuda")
    st = trainer.state
    order = trainer.batches()
    fn = make_device_data_train_fn(trainer.gan, cfg, 1)
    i = 0

    def one(eager: bool):
        nonlocal i
        kind = st.step % cfg.v2.r1_interval == 0
        idx = order[i % len(order)]
        i += 1
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        if eager:
            m = host_metrics(trainer.train_step(st, trainer.real_batch(idx)))
        else:
            m = host_metrics({k: v[0] for k, v in fn(st, trainer.dataset, idx[None]).items()})
        torch.cuda.synchronize()
        return kind, 1e3 * (time.perf_counter() - t0), m, dict(build.LAUNCHES)

    for _ in range(2):
        one(True)
    _settle()
    eager = {True: [], False: []}
    for _ in range(4):
        kind, ms, _, _ = one(True)
        eager[kind].append(ms)
    for _ in range(2):
        one(False)  # the two captures
    if len(fn.graphs) != 2:
        raise AssertionError(f"{tag}: {len(fn.graphs)} captured graphs, expected 2")
    captured, launches, d_r1 = {True: [], False: []}, {}, []
    for _ in range(6):
        kind, ms, m, launched = one(False)
        captured[kind].append(ms)
        launches[kind] = {k: v for k, v in launched.items() if v}
        if kind:
            d_r1.append(m["d_r1"])
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"{tag}: non-finite metrics {m}")
    for kind, per in launches.items():
        _check_launches(per, R1_KERNELS[label], _r1_block_forwards(label, cfg, kind))
    rec = {"captured_ms_with_r1": sum(captured[True]) / 3,
           "captured_ms_without_r1": sum(captured[False]) / 3,
           "eager_ms_with_r1": sum(eager[True]) / 2, "eager_ms_without_r1": sum(eager[False]) / 2,
           "d_r1": d_r1, "launches_with_r1": launches[True],
           "launches_without_r1": launches[False]}
    print(f"{tag}: captured {rec['captured_ms_with_r1']:.2f} ms with R1, "
          f"{rec['captured_ms_without_r1']:.2f} without; eager {rec['eager_ms_with_r1']:.2f} / "
          f"{rec['eager_ms_without_r1']:.2f}; d_r1 {d_r1}; launches a step with R1 "
          f"{launches[True]}, without {launches[False]}")
    trainer.metrics.close()  # its writer thread, before the caller removes run_dir
    del trainer, st, fn
    torch.cuda.empty_cache()
    return rec


def _r1_step_vs_plain() -> dict:
    """One R1 step (dropout 0) from one state, batch, latents and augment
    draws on each kernel route and on use_pallas=never: losses within
    LOSS_TOL, norms within NORM_RTOL, d_r1 within NORM_RTOL, every gradient
    leaf within LEAF_RTOL * max|plain leaf|."""
    import torch

    from vitgan_tpu_torch.data.datasets import synthetic_dataset
    from vitgan_tpu_torch.models import build_gan
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.ops.augment import draw_augment
    from vitgan_tpu_torch.ops.policy import apply_from_runtime, get_policy, set_policy
    from vitgan_tpu_torch.train.sample import latent_rng
    from vitgan_tpu_torch.train.state import create_train_state
    from vitgan_tpu_torch.train.step import host_metrics, make_train_step

    b = R1_OVER["v2.batch_size"]
    images, _ = synthetic_dataset(b, 32, 3, seed=SEED)
    real = torch.from_numpy(images).cuda().float() * (2.0 / 255.0) - 1.0
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    saved = get_policy()
    res, out = {}, {}
    try:
        for label, route_over in (*R1_ROUTES, ("plain", {"runtime.use_pallas": "never"})):
            cfg = _r1_cfg(route_over, **{"v2.dropout": 0.0})
            apply_from_runtime(cfg.runtime)
            gan = build_gan(cfg)
            if not res:
                z = gan.sample_latent(latent_rng(SEED, 0), b)
                probe = real.to(torch.bfloat16)
                draws = {key: draw_augment(gen, probe, cfg.run.diff_augment)
                         for key in ("aug_real", "aug_fake", "aug_g")}
            state = create_train_state(gan, cfg, device="cuda")
            build.reset_launches()
            m = host_metrics(make_train_step(gan, cfg)(state, real, z=z, draws=draws))
            launched = {k: v for k, v in build.LAUNCHES.items() if v}
            if (label == "plain") == bool(launched):
                raise AssertionError(f"[double backward] {label} launched {launched}")
            res[label] = (m, [p.grad.float() for p in (*state.g.parameters(),
                                                       *state.d.parameters())],
                          [f"g.{n}" for n, _ in state.g.named_parameters()]
                          + [f"d.{n}" for n, _ in state.d.named_parameters()])
            print(f"[double backward] one R1 step (dropout 0) on {label}: {m}, launches "
                  f"{launched}")
            del state
            torch.cuda.empty_cache()
    finally:
        set_policy(**saved)
    mp, gp, names = res["plain"]
    for label, _ in R1_ROUTES:
        mk, gk, _ = res[label]
        r = out[label] = {}
        for key, bound, rel in (("d_loss", LOSS_TOL, False), ("g_loss", LOSS_TOL, False),
                                ("d_grad_norm", NORM_RTOL, True),
                                ("g_grad_norm", NORM_RTOL, True), ("d_r1", NORM_RTOL, True)):
            r[key] = abs(mk[key] - mp[key]) / (abs(mp[key]) if rel else 1.0)
            if not r[key] <= bound:
                raise AssertionError(f"[double backward] {label} {key}: {mk[key]} against the "
                                     f"plain {mp[key]} ({r[key]:.3g} over {bound})")
        worst, worst_name = 0.0, ""
        for name, a, b_ in zip(names, gk, gp):
            rel = (a - b_).abs().max().item() / max(b_.abs().max().item(), 1e-30)
            if not math.isfinite(rel) or rel > worst:
                worst, worst_name = rel, name
        r["worst_leaf_rel"], r["worst_leaf"] = worst, worst_name
        print(f"[double backward] {label} against plain: {r} (limits: losses {LOSS_TOL}, norms "
              f"and d_r1 {NORM_RTOL} relative, leaves {LEAF_RTOL})")
        if not worst <= LEAF_RTOL:
            raise AssertionError(f"[double backward] {label}: leaf {worst_name} at {worst:.3g}")
    return out


def double_backward_path(work: str) -> dict:
    """[double backward]: R1 through the recompute Functions on the card,
    captured and eager, on both routes; one step of each held to the plain
    route."""
    out = {}
    for label, route_over in R1_ROUTES:
        out[label] = _r1_route(label, route_over, os.path.join(work, label))
        shutil.rmtree(os.path.join(work, label), ignore_errors=True)
    out["against_plain"] = _r1_step_vs_plain()
    return out


# [int8 serve]: the JAX package's sampler bounds (tests/test_quantize.py:123-124)
INT8_MEAN_TOL, INT8_P99_TOL = 4.0, 24.0


def int8_serve(run_dir: str) -> dict:
    """[int8 serve]: highres128 at batch 64 from the [serve] run directory on
    the megablock serving route, float weights and int8 in one call: weight
    bytes, call time (host clock to the uint8 readback, mean of 3 after the
    warm-up), launches of one call (equal), the seeded uint8 output's drift."""
    import numpy as np
    import torch

    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.serve import load_service
    from vitgan_tpu_torch.utils.quantize import QuantLeaf

    res, outs = {}, {}
    for mode in ("none", "int8"):
        svc = load_service(run_dir, batch=64, quantize=None if mode == "none" else mode)
        if mode == "int8":
            # no float copy of the weights on the card, the int8 leaves there
            if any(p.device.type != "meta" for p in svc.generator.parameters()):
                raise AssertionError("the int8 route kept the float weights")
            quant = [w for w in svc.weights.values() if isinstance(w, QuantLeaf)]
            if not quant or any(w.q.dtype != torch.int8 or not w.q.is_cuda for w in quant):
                raise AssertionError("the int8 weights are not int8 on the card")
        torch.cuda.synchronize()
        build.reset_launches()
        outs[mode] = svc._sample(svc.generator, 11, 0)
        torch.cuda.synchronize()
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        times = []
        for call in range(1, 4):
            t0 = time.perf_counter()
            svc._sample(svc.generator, 11, call)
            times.append(1e3 * (time.perf_counter() - t0))
        res[mode] = {"weight_bytes": svc.info()["weight_bytes"], "call_ms": sum(times) / 3,
                     "launches": launches, "info": svc.info()}
        print(f"[int8 serve] quantize={mode}: weight_bytes {res[mode]['weight_bytes']}, "
              f"{res[mode]['call_ms']:.2f} ms a batch-64 call (uint8 readback included), "
              f"launches of one call {launches}")
        del svc
        torch.cuda.empty_cache()
    if res["int8"]["launches"] != res["none"]["launches"]:
        raise AssertionError("int8 serving launched other kernels than the float route")
    _check_launches(res["int8"]["launches"], {"ln_qkv_fwd": 1, "flash_attn_fwd": 1,
                                              "proj_ln_mlp_fwd": 1,
                                              **LN_MLP_STAGES["proj_ln_mlp_fwd"]}, 12)
    diff = np.abs(outs["int8"].astype(np.int32) - outs["none"].astype(np.int32))
    drift = {"mean": float(diff.mean()), "p99": float(np.quantile(diff, 0.99)),
             "max": int(diff.max())}
    print(f"[int8 serve] seeded uint8 drift against the float route: {drift} (limits mean "
          f"{INT8_MEAN_TOL}, p99 {INT8_P99_TOL}); bytes {res['int8']['weight_bytes']} against "
          f"{res['none']['weight_bytes']} ({res['none']['weight_bytes'] / res['int8']['weight_bytes']:.2f}x)")
    if not (drift["mean"] <= INT8_MEAN_TOL and drift["p99"] <= INT8_P99_TOL):
        raise AssertionError(f"int8 drift {drift} over the bounds")
    res["drift"] = drift
    return res


def _reference_vit_d(path: str, cfg) -> int:
    """highres128's discriminator as the reference v2 ViTDiscriminator's
    state_dict ('vit.' keys, a 10-class head), from seeded numpy, saved to
    ``path``: weights N(0, 0.02), LayerNorm scales 1 + N(0, 0.02)."""
    import numpy as np
    import torch

    from vitgan_tpu_torch.models import build_gan
    from vitgan_tpu_torch.utils.torch_export import export_checkpoint
    from vitgan_tpu_torch.weights import _unflatten

    with torch.device("meta"):
        d = build_gan(cfg).discriminator_init(None, device="meta")
    rng = np.random.default_rng(SEED)
    flat = {k: (float(k.endswith(".scale")) + 0.02 * rng.standard_normal(tuple(t.shape))
                ).astype(np.float32) for k, t in d.state_dict().items()}
    sd = export_checkpoint({"params": _unflatten(flat), "state": {}}, "v2", prefix="vit.")
    e = cfg.v2.embed_dim
    sd["vit.classifier.fc2.weight"] = (0.02 * rng.standard_normal((10, e))).astype(np.float32)
    sd["vit.classifier.fc2.bias"] = np.zeros(10, np.float32)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    return len(sd)


def interop_path(work: str) -> tuple:
    """[interop]: `cli train --preset highres128 --warm-start-d` from a
    reference-format v2 discriminator .pth (a warm-up epoch of 3 steps, the
    capture among them, then 3 captured steps, under the preset's defaults,
    megablock=auto), the leaves loaded and bit-equal to the import; then `cli
    export-torch` of the trained D, re-imported, bit-equal to the run's
    checkpoint leaf for leaf."""
    import torch

    from vitgan_tpu_torch import cli
    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.utils.checkpoint import CheckpointManager
    from vitgan_tpu_torch.utils.torch_port import import_checkpoint
    from vitgan_tpu_torch.weights import from_jax_tree

    os.makedirs(work, exist_ok=True)
    cfg = C.highres_config(128)
    ref = os.path.join(work, "reference_vit_d.pth")
    n_keys = _reference_vit_d(ref, cfg)
    want = from_jax_tree(import_checkpoint(ref, "v2", num_heads=cfg.v2.num_heads))
    run = os.path.join(work, "warm")
    seen = {}
    real_warm = cli._warm_start_d

    def spy(trainer, path, cfg_):
        seen["loaded"] = real_warm(trainer, path, cfg_)
        seen["total"] = len(trainer.state.d.state_dict())
        seen["equal"] = all(torch.equal(v.cpu(), want[k])
                            for k, v in trainer.state.d.state_dict().items())
        return seen["loaded"]

    cli._warm_start_d = spy
    steps = 3
    try:
        _settle()
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["train", "--preset", "highres128", "--dataset", "synthetic", "--run-dir",
                       run, "--epochs", "2", "--warm-start-d", ref,
                       *sum((["--set", f"{k}={json.dumps(v)}"] for k, v in _fit_over({
                           "run.steps_per_epoch": steps, "data.synthetic_samples": 256}).items()),
                            [])])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
    finally:
        cli._warm_start_d = real_warm
    if rc != 0 or not seen.get("equal") or seen["loaded"] != seen["total"]:
        raise AssertionError(f"[interop] train --warm-start-d: rc {rc}, {seen}")
    with open(os.path.join(run, "logs", "scalars.jsonl")) as f:
        img_s = [r["value"] for r in map(json.loads, f) if r["tag"] == "train/images_per_sec"][-1]
    ms = 1e3 * cfg.v2.batch_size / img_s
    grid = {"ln_qkv_fwd": 12, "flash_attn_fwd": 12, "proj_ln_mlp_fwd": 12,
            **{k: 12 * v for k, v in LN_MLP_STAGES["proj_ln_mlp_fwd"].items()}}
    per_step = _check_fit_launches("[interop]", launches,
                                   train_kernels("auto", cfg.runtime.remat), 2 * steps, grid)
    print(f"[interop] train --preset highres128 --warm-start-d: {seen['loaded']} of "
          f"{seen['total']} D leaves loaded from a {n_keys}-key reference state_dict (bit-equal "
          f"to its import), a warm-up epoch of {steps} and {steps} captured steps at "
          f"{ms:.2f} ms/step ({sec:.1f} s with set-up), launches {launches}")
    out = os.path.join(work, "d_export.pth")
    if cli.main(["export-torch", "--run-dir", run, "--out", out]) != 0:
        raise AssertionError("[interop] export-torch failed")
    back = from_jax_tree(import_checkpoint(out, "v2", num_heads=cfg.v2.num_heads))
    trained = CheckpointManager(os.path.join(run, "checkpoints")).restore()[0]["state"]["d"]
    unequal = [k for k, v in trained.items() if not torch.equal(back[k], v)]
    if set(back) != set(trained) or unequal:
        raise AssertionError(f"[interop] export-torch re-imported: not bit-equal at {unequal}")
    moved = sum(not torch.equal(trained[k], want[k]) for k in want)
    print(f"[interop] export-torch of the trained D ({moved} of {len(want)} leaves moved from "
          f"the import) re-imported bit-equal, leaf for leaf")
    return per_step, {"leaves_loaded": seen["loaded"], "leaves": seen["total"],
                      "ms_per_step": ms, "steps": 2 * steps, "launches": launches,
                      "export_reimport_bit_equal": True}


BASELINES = ("dcgan", "cnn", "mlp")


def baselines_path(work: str) -> dict:
    """[baselines]: dcgan, cnn and mlp at their default configs (32 px;
    batch 128, 64, 128) on synthetic data through Trainer: an eager step
    timed, a warm-up epoch of 3 (the capture), 3 captured steps by fit; the
    captured steps against eager ones ([captured vs eager]'s terms); for dcgan
    and cnn, `cli export-torch` of G and `cli generate --from-torch`."""
    import torch

    from vitgan_tpu_torch import cli
    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.models import count_params
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.train.step import host_metrics
    from vitgan_tpu_torch.train.trainer import Trainer

    out = {}
    for family in BASELINES:
        tag = f"[baselines] {family}"
        steps = 3
        b = getattr(C.ExperimentConfig(), family).batch_size
        cfg = C.replace(C.ExperimentConfig(family=family), **_fit_over({
            "data.dataset": "synthetic", "data.synthetic_samples": 4 * b, "run.epochs": 2,
            "run.steps_per_epoch": steps}))
        run = os.path.join(work, family)
        trainer = Trainer(cfg, run_dir=run, device="cuda")
        st = trainer.state
        host_metrics(trainer.train_step(st, trainer.real_batch(trainer.batches()[0])))
        eager_ms = _eager_step_ms(trainer, steps)
        trainer.fit(epochs=1)
        _settle()
        torch.cuda.synchronize()
        build.reset_launches()
        means = trainer.fit()
        if any(build.LAUNCHES.values()):
            raise AssertionError(f"{tag} launched a kernel: {dict(build.LAUNCHES)}")
        if not all(math.isfinite(means[k]) for k in ("d_loss", "g_loss")):
            raise AssertionError(f"{tag}: non-finite metrics {means}")
        ms = 1e3 * b / means["images_per_sec"]
        rec = {"batch": b, "g_params": count_params(st.g), "d_params": count_params(st.d),
               "d_has_batch_stats": trainer.gan.d_has_batch_stats, "ms_per_step": ms,
               "eager_ms_per_step": eager_ms}
        print(f"{tag}: batch {b}, G {rec['g_params']} D {rec['d_params']} parameters, "
              f"{steps} captured steps at {ms:.3f} ms/step against {eager_ms:.3f} eager; "
              f"{means}")
        del trainer, st
        torch.cuda.empty_cache()
        # its order needs 1 + steps batches: the epoch uncut (4 of them)
        rec["captured_vs_eager"] = captured_vs_eager(
            C.replace(cfg, **{"run.steps_per_epoch": None}), steps, family)
        if family in ("dcgan", "cnn"):
            g_pth = os.path.join(work, f"{family}_g.pth")
            if cli.main(["export-torch", "--run-dir", run, "--role", "generator",
                         "--out", g_pth]) != 0 or cli.main(
                    ["generate", "--from-torch", g_pth, "--family", family,
                     "--num-images", "16"]) != 0:
                raise AssertionError(f"{tag}: export-torch / generate --from-torch failed")
            with open(os.path.join(work, "vitgan_tpu_samples", "generated_images.png"),
                      "rb") as f:
                h, w = _png_shape(f.read())
            if (h, w) != (4 * 34 + 2, 4 * 34 + 2):
                raise AssertionError(f"{tag}: generate --from-torch wrote a {h}x{w} grid")
            rec["generate_from_torch"] = f"{h}x{w}"
            print(f"{tag}: export-torch of G, generate --from-torch wrote a {h}x{w} grid")
        out[family] = rec
    return out


# --- the 4,096-token preset, remat, gradient accumulation, bench and the CLI --------

P4_STEPS = 3  # run.steps_per_epoch of the [highres256p4] fit
REMAT_STEPS = 3  # steps per call of each [remat] mode


def _p4_cfg(**over):
    """highres256p4 at its preset (remat attn, DiffAugment, dropout 0.1) on 64
    synthetic images, for the fit-driven phases."""
    from vitgan_tpu_torch import config as C

    return C.replace(C.highres256p4_config(), **_fit_over({
        "data.dataset": "synthetic", "data.synthetic_samples": 64, **over}))


def train_p4(run_dir: str) -> tuple:
    """[highres256p4]: the 4,096-token preset at full width (256 px at patch 4,
    embed 384, 6 heads of 64, hidden 1,536, depth 12, batch 8, remat 'attn')
    through Trainer on synthetic data: 1 eager warm-up step, 2 eager steps
    timed, a warm-up epoch of P4_STEPS (the capture), then a timed epoch of
    P4_STEPS captured steps by fit, after _settle: ms/step, peak memory, the
    launches per step (flash forward, single pass and LN->MLP in every block;
    none of the megablock's, the two-pass backward or wgrad_gemm), a profiled
    breakdown with the idle share.  Returns (trainer, launches per step,
    record, the state before the first step)."""
    import torch

    from vitgan_tpu_torch.models import count_params
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.train.step import host_metrics
    from vitgan_tpu_torch.train.trainer import Trainer

    tag = "[highres256p4]"
    cfg = _p4_cfg(**{"run.epochs": 2, "run.steps_per_epoch": P4_STEPS})
    m = cfg.v2
    t0 = time.perf_counter()
    trainer = Trainer(cfg, run_dir=run_dir, device="cuda")
    st = trainer.state
    setup = time.perf_counter() - t0
    n = (m.image_size // m.patch_size) ** 2
    print(f"{tag} {m.image_size} px at patch {m.patch_size}: {n} tokens ({n + 1} in D), embed "
          f"{m.embed_dim}, {m.num_heads} heads, depth {m.depth}, batch {m.batch_size}, remat "
          f"{cfg.runtime.remat!r}, dropout {m.dropout}, augment {cfg.run.diff_augment!r}; G "
          f"{count_params(st.g)} D {count_params(st.d)} parameters; set up in {setup:.1f} s")
    start = st.state_dict()  # on the CPU: [remat] and the route comparison start from it
    t0 = time.perf_counter()
    warm = host_metrics(trainer.train_step(st, trainer.real_batch(trainer.batches()[0])))
    print(f"{tag} 1 eager warm-up step in {time.perf_counter() - t0:.2f} s: {warm}")
    eager_ms = _eager_step_ms(trainer, 2)
    grid = _grid_launches(trainer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.fit(epochs=1)  # the warm-up epoch: its first step eager, then captured
    warm_s = time.perf_counter() - t0
    _settle()
    torch.cuda.synchronize()
    build.reset_launches()
    # --- the main path ---
    means = trainer.fit()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    # --- end of the main path ---
    peak = torch.cuda.max_memory_allocated()
    ms = 1e3 * m.batch_size / means["images_per_sec"]
    want = train_kernels("p4", cfg.runtime.remat)
    per_step = _check_fit_launches(tag, launches, want, P4_STEPS, grid)
    if not all(math.isfinite(means[k]) for k in ("d_loss", "g_loss", "d_grad_norm",
                                                 "g_grad_norm")):
        raise AssertionError(f"{tag} non-finite train metrics: {means}")
    print(f"{tag} {_smi()}: {P4_STEPS} captured steps by Trainer.fit: {ms:.2f} ms/step, "
          f"{means['images_per_sec']:.2f} img/s; the eager step {eager_ms:.2f} ms; peak "
          f"{peak / 2**30:.2f} GiB allocated over the capture and both epochs; warm-up epoch "
          f"{warm_s:.1f} s; launches a step {want}")
    breakdown = train_breakdown(trainer, ms, recompute=True)
    trainer._build_device_fns()  # drop the fit's captured graphs and their memory pool
    rec = {"card": _smi(), "ms_per_step": ms, "eager_ms_per_step": eager_ms,
           "img_per_s": means["images_per_sec"], "peak_allocated_bytes": peak,
           "launches_per_step": {k: v // P4_STEPS for k, v in per_step.items() if v},
           "setup_s": setup, "means": means, "breakdown": breakdown}
    return trainer, rec, start


def _hold_route_step(tag: str, kern: tuple, plain: tuple, scalar_scale: dict) -> dict:
    """One train step's metrics and gradient leaves on a kernel route held to
    the plain route's (compare_train_routes' bounds); a one-element leaf, a
    sum over the batch's samples, within LEAF_RTOL of the sum of its
    per-sample terms' magnitudes (``scalar_scale``), as the v1 comparison
    holds it."""
    (mk, gk, names), (mp, gp, _) = kern, plain
    r = {}
    for key in ("d_loss", "g_loss"):
        r[key] = abs(mk[key] - mp[key])
        if not r[key] <= LOSS_TOL:
            raise AssertionError(f"{tag} {key}: kernels {mk[key]} plain {mp[key]}")
    for key in ("d_grad_norm", "g_grad_norm"):
        r[key] = abs(mk[key] - mp[key]) / mp[key]
        if not r[key] <= NORM_RTOL:
            raise AssertionError(f"{tag} {key}: kernels {mk[key]} plain {mp[key]}")
    worst, worst_name = 0.0, ""
    for name, a, b in zip(names, gk, gp):
        scale = scalar_scale[name] if b.numel() == 1 else b.abs().max().item()
        rel = (a - b).abs().max().item() / max(scale, 1e-30)
        if not math.isfinite(rel) or rel > worst:
            worst, worst_name = rel, name
    r["worst_leaf_rel"], r["worst_leaf"] = worst, worst_name
    print(f"{tag} losses |d| {r['d_loss']:.3g} / {r['g_loss']:.3g} (tolerance {LOSS_TOL}), norms "
          f"relative {r['d_grad_norm']:.3g} / {r['g_grad_norm']:.3g} (tolerance {NORM_RTOL}), "
          f"{len(names)} gradient leaves, worst max|d| / max|plain| {worst:.4g} at {worst_name} "
          f"(tolerance {LEAF_RTOL})")
    if not worst <= LEAF_RTOL:
        raise AssertionError(f"{tag} a gradient leaf differs from the plain route")
    return r


def p4_against_plain(trainer, start: dict) -> dict:
    """One highres256p4 train step from the same state (the preset's
    dropout and augment draws, the same generator state, so both routes draw
    the same masks) on the kernel route and on use_pallas=never, under the
    preset's remat 'attn' (the plain route keeps its products; its chunked
    attention recomputes each chunk's scores in the backward): held in the
    route comparison's bounds; each route's peak memory."""
    import torch

    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.ops.policy import get_policy, set_policy
    from vitgan_tpu_torch.train.step import host_metrics

    st = trainer.state
    real = trainer.real_batch(trainer.batches()[0])
    saved = get_policy()
    res = {}
    # D's head bias is the sum over the D update's 2B rows of dlogit: the sum
    # of their magnitudes, on the plain route, is the scale it is held at
    dlogit = []

    def record(module, args, y):
        if y.requires_grad and y.shape[0] == 2 * real.shape[0]:
            y.register_hook(lambda dy: dlogit.append(dy.detach().float()))

    try:
        for route, policy in (("kernels", dict(mode="auto")), ("plain", dict(mode="never"))):
            set_policy(**policy)
            st.load_state_dict(start)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            build.reset_launches()
            hook = st.d.register_forward_hook(record) if route == "plain" else None
            t0 = time.perf_counter()
            metrics = host_metrics(trainer.train_step(st, real))
            sec = time.perf_counter() - t0
            if hook is not None:
                hook.remove()
            peak = torch.cuda.max_memory_allocated()
            # copies: the state's gradient buffers are zeroed in place next step
            res[route] = (metrics, [p.grad.float().clone() for p in (*st.g.parameters(),
                                                                     *st.d.parameters())],
                          [f"g.{n}" for n, _ in st.g.named_parameters()]
                          + [f"d.{n}" for n, _ in st.d.named_parameters()])
            launched = {k: v for k, v in build.LAUNCHES.items() if v}
            print(f"[highres256p4 routes] {route}: one eager step in {sec:.2f} s, peak "
                  f"{peak / 2**30:.2f} GiB, launches {launched}, metrics {metrics}")
            if route == "plain" and launched:
                raise AssertionError("the plain route launched a kernel")
            res[f"{route}_peak"], res[f"{route}_s"] = peak, sec
    finally:
        set_policy(**saved)
    head = dict(st.d.named_parameters())["head_fc2.b"].grad
    if len(dlogit) != 1 or not abs(dlogit[0].sum().item() - head.item()) <= \
            1e-3 * dlogit[0].abs().sum().item():
        raise AssertionError(f"D's head bias gradient {head.item()} is not the sum of the D "
                             f"update's dlogit ({len(dlogit)} recorded)")
    scale = {"d.head_fc2.b": dlogit[0].abs().sum().item()}
    print(f"[highres256p4 routes] D's head bias: plain gradient {head.item():.4g}, sum of "
          f"|dlogit| over the D update's rows {scale['d.head_fc2.b']:.4g}")
    out = _hold_route_step("[highres256p4 routes] kernels against plain:", res["kernels"],
                           res["plain"], scale)
    out.update({k: res[k] for k in ("kernels_peak", "plain_peak", "kernels_s", "plain_s")})
    return out


def _remat_modes(tag: str, trainer, start: dict, modes: tuple, route: str) -> dict:
    """Each remat mode from the same state, batch order and generator state:
    a device-data function of REMAT_STEPS steps, its first call (the eager
    step, its capture, the replays) then a timed call of replays; ms/step,
    the peak memory over both calls, launches a step (held to train_kernels
    for ``route``), and the state after the 2 x REMAT_STEPS steps against
    'never''s: bit-equal, else within the captured-against-eager bounds."""
    import gc

    import numpy as np
    import torch

    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.ops.policy import get_policy, set_policy
    from vitgan_tpu_torch.train.step import host_metrics, make_device_data_train_fn

    st, cfg, b = trainer.state, trainer.cfg, trainer.cfg.model.batch_size
    idx = np.random.default_rng(SEED).integers(0, len(trainer.dataset), (2, REMAT_STEPS, b))
    saved = get_policy()
    out, states = {}, {}
    try:
        for mode in modes:
            set_policy(remat=mode)
            st.load_state_dict(start)
            fn = make_device_data_train_fn(trainer.gan, cfg, REMAT_STEPS)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            host_metrics({k: v[-1] for k, v in fn(st, trainer.dataset, idx[0]).items()})
            torch.cuda.synchronize()
            build.reset_launches()
            t0 = time.perf_counter()
            m = host_metrics({k: v[-1] for k, v in fn(st, trainer.dataset, idx[1]).items()})
            ms = 1e3 * (time.perf_counter() - t0) / REMAT_STEPS
            peak = torch.cuda.max_memory_allocated()
            launches = {k: v // REMAT_STEPS for k, v in build.LAUNCHES.items() if v}
            want = train_kernels(route, mode)
            if launches != {k: v for k, v in want.items() if v}:
                raise AssertionError(f"{tag} remat={mode}: launches a step {launches}, "
                                     f"expected {want}")
            if not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"{tag} remat={mode}: non-finite metrics {m}")
            states[mode] = _flat_state(st)
            out[mode] = {"ms_per_step": ms, "peak_allocated_bytes": peak,
                         "launches_per_step": launches}
            print(f"{tag} remat={mode}: {ms:.2f} ms/step ({REMAT_STEPS} replays), peak "
                  f"{peak / 2**30:.2f} GiB over the capture and 2 calls, launches a step "
                  f"{launches}")
            del fn
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        set_policy(**saved)
    st.load_state_dict(start)
    start_flat = _flat_state(st)
    for mode in modes[1:]:
        groups = _hold_states(f"{tag} remat={mode} against never:", start_flat,
                              states[modes[0]], states[mode])
        out[mode]["bit_equal_to_never"] = all(r["bit_equal"] == r["leaves"]
                                              for r in groups.values())
        print(f"{tag} remat={mode}: the state after {2 * REMAT_STEPS} steps is "
              f"{'bit-equal' if out[mode]['bit_equal_to_never'] else 'NOT bit-equal'} to "
              f"remat=never's")
    return out


def remat_path(p4_trainer, p4_start: dict) -> dict:
    """[remat]: highres256p4 in each mode (never, full, dots, attn), then
    highres128 at its preset ('attn', the megablock route) against 'never'
    (its megablock forward's launches doubled), each mode's state held to
    'never''s."""
    import torch

    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.train.trainer import Trainer

    out = {"card": _smi(),
           "highres256p4": _remat_modes("[remat] highres256p4", p4_trainer, p4_start,
                                        ("never", "full", "dots", "attn"), "p4")}
    cfg = C.replace(C.highres_config(128), **_fit_over({
        "data.dataset": "synthetic", "data.synthetic_samples": 256}))
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_remat128")
    try:
        trainer = Trainer(cfg, run_dir=base, device="cuda")
        out["highres128"] = _remat_modes("[remat] highres128", trainer,
                                         trainer.state.state_dict(), ("never", "attn"), "auto")
        trainer.metrics.close()  # its writer thread, before the run directory goes
        del trainer
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(base, ignore_errors=True)
    r = out["highres128"]
    print(f"[remat] {out['card']}: highres128 'attn' {r['attn']['ms_per_step']:.2f} ms/step "
          f"against 'never' {r['never']['ms_per_step']:.2f}, peak "
          f"{r['attn']['peak_allocated_bytes'] / 2**30:.2f} against "
          f"{r['never']['peak_allocated_bytes'] / 2**30:.2f} GiB")
    return out


def grad_accum_path(work: str) -> dict:
    """[grad accum]: highres128 with gen_optim.grad_accum = disc_optim.grad_accum
    = 2 and run.ema_decay 0.999: n = 4 captured steps against 4 eager ones
    across accumulation boundaries (the graphs of both kinds, accumulating
    and applying; captured_vs_eager's terms); then 2 epochs of 3 steps
    uninterrupted against 1 epoch, its checkpoint (G's and D's accumulators
    half full), a fresh Trainer's resume() and the second epoch: bit-equal."""
    import torch

    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.train.trainer import Trainer

    tag = "[grad accum]"
    # depth 6 of the preset's 12 since PR 19 (the script's time, which [pipeline]
    # spends at depth 12); the accumulation's checks do not depend on the depth
    cfg = C.replace(C.highres_config(128), **_fit_over({
        "data.dataset": "synthetic", "data.synthetic_samples": 256, "run.ema_decay": 0.999,
        "v2.depth": 6,
        "v2.gen_optim.grad_accum": 2, "v2.disc_optim.grad_accum": 2,
        "run.steps_per_epoch": 3}))
    out = {"captured_vs_eager": captured_vs_eager(C.replace(cfg, **{"run.steps_per_epoch": None}),
                                                  4, "highres128 grad_accum=2")}

    def run(name: str, epochs: int, resume: bool = False) -> tuple:
        trainer = Trainer(cfg, run_dir=os.path.join(work, name), device="cuda")
        if resume:
            trainer.resume()
        trainer.fit(epochs=epochs)
        st = trainer.state
        mini = (int(st.g_opt.mini_step), int(st.d_opt.mini_step))
        flat = _flat_state(st)
        del trainer, st
        torch.cuda.empty_cache()
        return flat, mini

    whole, _ = run("whole", 2)
    _, mid = run("part", 1)
    resumed, _ = run("part", 2, resume=True)
    if mid != (1, 1):
        raise AssertionError(f"{tag} the checkpoint after 3 calls holds mini steps {mid}")
    differ = [k for k in whole if not torch.equal(whole[k], resumed[k])]
    print(f"{tag} highres128 at depth 6, grad_accum 2 on G and D, EMA 0.999: a run resumed "
          f"after 3 steps "
          f"(mini steps {mid}) against 6 uninterrupted steps: {len(whole) - len(differ)} of "
          f"{len(whole)} leaves bit-equal")
    if differ:
        raise AssertionError(f"{tag} the resumed run differs at {differ[:5]}")
    out["resume"] = {"leaves": len(whole), "bit_equal": True, "mini_steps_at_checkpoint": mid}
    return out


def bench_path(p4_ms: float) -> dict:
    """[bench]: `cli bench --preset highres256p4 --scan 3 --iters 2 --flops`,
    its JSON line; its images/s within 5% of [highres256p4]'s captured step;
    the FLOP model's GFLOP a step and the TFLOP/s it sustains on the card."""
    import contextlib

    import torch

    from vitgan_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench", "--preset", "highres256p4", "--scan", "3", "--iters", "2",
                       "--flops"])
    sec = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli bench: rc {rc}")
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    fit_ips = 8 * 1e3 / p4_ms
    ratio = rec["value"] / fit_ips
    print(f"[bench] {_smi()}: {json.dumps(rec)} in {sec:.1f} s; [highres256p4]'s captured "
          f"step {fit_ips:.2f} img/s (ratio {ratio:.4f})")
    torch.cuda.empty_cache()
    if not 0.95 <= ratio <= 1.05:
        raise AssertionError(f"[bench] {rec['value']} img/s against the fit's {fit_ips:.2f}")
    return {**rec, "fit_img_per_s": fit_ips, "ratio": ratio, "seconds": sec}


def _cli_warmup(label: str) -> float:
    """`cli warmup v2` (every kernel source built, nvcc in parallel, then the
    batch assembler and the preset's Trainer) with the build directory
    ``label`` ("clean" or "built"): its seconds; raises unless it exits 0 with
    every library built."""
    import contextlib

    from vitgan_tpu_torch import cli
    from vitgan_tpu_torch.ops import build

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["warmup", "v2"])
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    built = sum(os.path.exists(build.lib_path(n)) for n in build.SOURCES)
    print(f"[cli] warmup v2 with the build directory {label}: rc {rc}, "
          f"{rec['compile_seconds']['v2']} s; {built} of {len(build.SOURCES)} kernel "
          "libraries built")
    if rc != 0 or built != len(build.SOURCES):
        raise AssertionError(f"[cli] warmup ({label}): rc {rc}, {built} libraries")
    return rec["compile_seconds"]["v2"]


def cli_path(warmup_clean_s: float) -> dict:
    """[cli]: `cli doctor` exits 0 on the card; `cli warmup v2` with the
    kernels built: its seconds, beside the clean build's ``warmup_clean_s``
    (main's first build is `cli warmup v2` on an empty build directory)."""
    import contextlib

    from vitgan_tpu_torch import cli

    out = {}
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["doctor"])
    checks = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"[cli] doctor: rc {rc} in {time.perf_counter() - t0:.1f} s: "
          f"{ {k: v['ok'] for k, v in checks.items()} }")
    if rc != 0 or not checks["devices"]["ok"]:
        raise AssertionError(f"[cli] doctor: rc {rc}, {checks['devices']}")
    out["doctor"] = checks
    out["warmup_built_s"] = _cli_warmup("built")
    out["warmup_clean_s"] = warmup_clean_s
    return out


SWEEP_SEED = 2  # its trials: embed 256, 256, 128, 512 (the LN->MLP gate passes 256 and 512)
SWEEP_CUTS = ("run.steps_per_epoch=8", "run.fid_num_samples=1024")
VEC_STEPS = 4  # run.steps_per_epoch of the vectorized group
VEC_TOL = 1e-4  # a one-trial group against the in-place step: both run make_train_step


def _cli_json(args: list) -> tuple:
    """(rc, the JSON object printed last) of one `cli` call."""
    import contextlib

    from vitgan_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    out = buf.getvalue()
    return rc, json.loads(out[out.rindex("\n{\n") + 1:] if "\n{\n" in out else out)


def sweep_path(work: str) -> dict:
    """[sweep] (phase 31)."""
    import numpy as np
    import torch

    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.hpo import sweep as SW
    from vitgan_tpu_torch.models import build_gan
    from vitgan_tpu_torch.ops.policy import apply_from_runtime
    from vitgan_tpu_torch.train.state import create_train_state
    from vitgan_tpu_torch.train.step import host_metrics, make_train_step
    from vitgan_tpu_torch.train.vstep import TrialGroup

    tag, smi = "[sweep]", _smi()
    d = os.path.join(work, "seq")
    args = ["sweep", "--num-trials", "4", "--seed", str(SWEEP_SEED), "--run-dir", d]
    for cut in SWEEP_CUTS:
        args += ["--set", cut]
    t0 = time.perf_counter()
    rc_a, _ = _cli_json(args + ["--trial-stride", "2", "--trial-offset", "0"])
    rc_b, best_b = _cli_json(args + ["--trial-stride", "2", "--trial-offset", "1"])
    seq_s = time.perf_counter() - t0
    if rc_a or rc_b:
        raise AssertionError(f"{tag} cli sweep: rc {rc_a}, {rc_b}")
    recs = sorted(SW._load_recorded_trials(os.path.join(d, "sweep_results.jsonl")).values(),
                  key=lambda r: r["trial"])
    if [r["trial"] for r in recs] != [0, 1, 2, 3]:
        raise AssertionError(f"{tag} the shared JSONL holds trials {[r['trial'] for r in recs]}")
    rng = np.random.default_rng(SWEEP_SEED)
    trials = []
    for r in recs:
        p = r["params"]
        if p != SW.sample_search_space(rng):
            raise AssertionError(f"{tag} trial {r['trial']} is not the seed's draw")
        k = {n: v for n, v in r["launches"].items() if v}
        rows = p["batch_size"] * 64  # 64 tokens in G (32 px at patch 4)
        # the auto gate: rows and hidden >= 512 (every width here is a multiple of 8;
        # E > 384 takes the wide LN -> fc1: the LN rows, then the streamed fc1)
        gated = p["embed_dim"] * 2 >= 512 and rows >= 2048
        fc1 = "ln_mlp_fc1_wide" if p["embed_dim"] > 384 else "ln_mlp_fc1"
        stages = k.get(fc1, 0), k.get("ln_mlp_linear", 0)
        if p["embed_dim"] > 384:
            stages += (k.get("ln_rows", 0),)
        print(f"{tag} {smi}: trial {r['trial']} {p}: {r['seconds']:.2f} s, FID {r['fid']:.4f}, "
              f"collapsed {r['collapsed']}, launches {k}")
        if gated and not all(stages):
            raise AssertionError(f"{tag} trial {r['trial']} passes the LN->MLP gate but launched "
                                 f"its stages {stages} times")
        if not gated and any(stages):
            raise AssertionError(f"{tag} trial {r['trial']} fails the LN->MLP gate but launched "
                                 f"its stages {stages} times")
        trials.append({"trial": r["trial"], "params": p, "seconds": r["seconds"],
                       "fid": r["fid"], "launches": k, "ln_mlp_gate": gated})
    if not any(t["ln_mlp_gate"] for t in trials):
        raise AssertionError(f"{tag} no trial of seed {SWEEP_SEED} passes the LN->MLP gate")
    on_disk = json.load(open(os.path.join(d, "best_config.json")))
    rc_r, best_r = _cli_json(args + ["--resume"])
    if rc_r or best_r != on_disk or best_b != on_disk:
        raise AssertionError(f"{tag} the rankings differ: worker B {best_b.get('trial')}, "
                             f"best_config {on_disk.get('trial')}, --resume {best_r.get('trial')}")
    if len(SW._load_recorded_trials(os.path.join(d, "sweep_results.jsonl"))) != 4:
        raise AssertionError(f"{tag} --resume trained a trial again")
    print(f"{tag} 4 trials by two workers in {seq_s:.1f} s; best trial {on_disk['trial']} (FID "
          f"{on_disk['fid']:.4f}), the same from the last worker and from --resume, which "
          "skipped every trial")
    out = {"trials": trials, "seconds": seq_s, "best_trial": on_disk["trial"],
           "cuts": list(SWEEP_CUTS), "seed": SWEEP_SEED}

    # --vectorize: 4 trials of the widest shape, one group
    rates = iter([(1e-4, 2e-4), (2e-4, 1e-4), (5e-5, 3e-4), (3e-4, 5e-5)])
    widest = {"embed_dim": 512, "num_heads": 8, "batch_size": 256}
    orig = SW.sample_search_space
    SW.sample_search_space = lambda rng: dict(zip(("gen_lr", "disc_lr"), next(rates)), **widest)
    base = C.replace(C.ExperimentConfig(family="v2", data=C.DataConfig(dataset="synthetic")), **{
        "run.epochs": 1, "run.steps_per_epoch": VEC_STEPS, "run.fid_num_samples": 1024,
        "run.checkpoint_every_epochs": 0, "run.sample_grid_every_epochs": 0})
    timings = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        best_v = SW.run_sweep_vectorized(num_trials=4, base_cfg=base,
                                         run_base=os.path.join(work, "vec"), timings=timings)
    finally:
        SW.sample_search_space = orig
    vec_s = time.perf_counter() - t0
    vrecs = SW._load_recorded_trials(os.path.join(work, "vec", "sweep_results.jsonl"))
    if (sorted(vrecs) != [0, 1, 2, 3] or [c["trials"] for c in timings] != [4]
            or any(r["group_size"] != 4 for r in vrecs.values())):
        raise AssertionError(f"{tag} --vectorize recorded {vrecs} in groups {timings}")
    if not all(np.isfinite(r["fid"]) for r in vrecs.values()):
        raise AssertionError(f"{tag} --vectorize gave a non-finite FID")
    group = timings[0]

    # one trial of that shape: a one-trial group against the in-place plain
    # step from one state and stream
    cfg = C.replace(SW._trial_config(base, dict(gen_lr=1e-4, disc_lr=2e-4, **widest)), **{
        "v2.gen_optim.inject_lr": True, "v2.disc_optim.inject_lr": True,
        "runtime.use_pallas": "never"})
    apply_from_runtime(cfg.runtime)
    gan = build_gan(cfg)
    b = cfg.v2.batch_size
    real = torch.rand((b, 32, 32, 3), generator=torch.Generator().manual_seed(SEED)) * 2 - 1
    one = TrialGroup(gan, cfg, [create_train_state(gan, cfg)], [1e-4], [2e-4])
    ref = create_train_state(gan, cfg)
    step = make_train_step(gan, cfg)
    mine = one.states[0]
    compared = {}
    for i in range(2):
        got_m = {k: float(v[0]) for k, v in one.step(real).items()}
        want_m = host_metrics(step(ref, real))
        for k, v in want_m.items():  # losses to 1e-4, norms to 1e-4 of themselves
            bound = VEC_TOL * (abs(v) if k.endswith("grad_norm") else 1.0)
            if not abs(got_m[k] - v) <= bound:
                raise AssertionError(f"{tag} one-trial group, step {i + 1}: {k} {got_m[k]} "
                                     f"against {v} (bound {bound:.1e})")
        compared[f"metrics_step{i + 1}_max_abs_diff"] = max(
            abs(got_m[k] - v) for k, v in want_m.items())
        if i == 0:  # Adam's first moments: the first step's clipped gradients
            for net in ("g", "d"):
                o_m, o_r = getattr(mine, f"{net}_opt").opt, getattr(ref, f"{net}_opt").opt
                worst, equal, leaves = 0.0, 0, 0
                for p_m, p_r in zip(getattr(mine, net).parameters(),
                                    getattr(ref, net).parameters()):
                    a_, b_ = o_m.state[p_m]["exp_avg"], o_r.state[p_r]["exp_avg"]
                    leaves += 1
                    if torch.equal(a_, b_):
                        equal += 1
                        continue
                    d = (a_ - b_).abs().max().item()
                    bound = VEC_TOL * b_.abs().max().item()
                    worst = max(worst, d / max(bound, 1e-30))
                    if not d <= bound:
                        raise AssertionError(f"{tag} one-trial group: {net} exp_avg apart by "
                                             f"{d:.3e} (bound {bound:.3e})")
                compared[f"{net}_exp_avg_step1"] = {"leaves": leaves, "bit_equal": equal,
                                                    "worst_share_of_bound": worst}
    for net, lr in (("g", 1e-4), ("d", 2e-4)):
        # Adam moves an element by at most its rate an update (1.41 x at the
        # second under beta2 0.99): a near-zero gradient rounded to opposite
        # signs parts two runs by twice that
        bound = 2 * 2 * math.sqrt(2) * lr
        mp = dict(getattr(mine, net).named_parameters())
        ds = {n: (mp[n] - p).detach().abs().max().item()
              for n, p in getattr(ref, net).named_parameters()}
        worst = max(ds.values())
        compared[net] = {"leaves": len(ds), "bit_equal": sum(d == 0 for d in ds.values()),
                         "max_abs_diff": worst, "bound": bound}
        if not worst <= bound:
            raise AssertionError(f"{tag} one-trial group: {net} parameters apart by {worst}")
    print(f"{tag} one-trial group against the in-place plain step, 2 steps: {compared}")

    def ms(fn, n=3):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / n

    step_ms = ms(lambda: host_metrics(step(ref, real)))
    print(f"{tag} {smi}: --vectorize, 4 trials at embed 512, 8 heads, batch 256, one group: "
          f"{group['steps']} steps in {group['seconds']:.1f} s, {group['step_ms']:.1f} ms to "
          f"step all four against the in-place plain step's {step_ms:.1f} (x4 = "
          f"{4 * step_ms:.1f}); peak {group['peak_gib']:.2f} GiB; best trial "
          f"{best_v['trial']}; the sweep {vec_s:.1f} s")
    out["vectorized"] = {"group": group, "all_four_step_ms": group["step_ms"],
                         "plain_step_ms": step_ms, "peak_gib": group["peak_gib"],
                         "seconds": vec_s, "best_trial": best_v["trial"],
                         "one_trial_vs_in_place": compared}
    del one, ref, step, mine
    torch.cuda.empty_cache()
    return out


def _mask_rows_check() -> dict:
    """The linear stage's dropout bits under a row map: a rank's half (4 of
    8 samples) of D's [real; fake] batch at G's width, each row keyed by its
    place in the global batch, against the plain version's bits (equal) and
    product (the route bounds); with the identity map equal to no map."""
    import torch

    from vitgan_tpu_torch.ops import fused_block as FB
    from vitgan_tpu_torch.ops import fused_mlp as FM

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n, e, b = 1024, 384, 8
    x = torch.randn((b * n, e), device="cuda", generator=gen).to(torch.bfloat16)
    attn = torch.randn((b * n, e), device="cuda", generator=gen).to(torch.bfloat16)
    w = (torch.randn((e, e), device="cuda", generator=gen) * e ** -0.5)
    bias = torch.randn((e,), device="cuda", generator=gen) * 0.1
    seed = torch.tensor([1234567890123], dtype=torch.int64, device="cuda")
    rows = (n, 4, 8, 4)
    out, mask = FM.linear_stage(attn, w, bias, x, seed, MB_RATE, 0, rows)
    want = FB.row_mask(seed, 0, (b * n, e), MB_RATE, rows)
    if not torch.equal(mask, want):
        raise AssertionError("[parallel] the linear stage's row-mapped dropout bits differ from "
                             "the plain version's")
    err = _err(out, FM.linear_stage_reference(attn, w, bias, x, want),
               "[parallel] linear stage, rows keyed by the global batch", residual=x)
    _, ident = FM.linear_stage(attn, w, bias, x, seed, MB_RATE, 0, (n, b, b, 0))
    _, plain = FM.linear_stage(attn, w, bias, x, seed, MB_RATE, 0)
    if not torch.equal(ident, plain):
        raise AssertionError("[parallel] the identity row map changed the dropout bits")
    return {"shape": [b * n, e], "rows": list(rows), "mask_equal": True, "max_abs_err": err}


def _place_one_way(state, mesh, tensor_parallel=False, fsdp=False, fsdp_min_size=2048):
    """Place ``state`` on a world-1 mesh under the plan of a data axis of 2
    and a model axis of 1 (parallel/sharding.placement_specs): each slice is
    a whole leaf, and every gather, reduce-scatter and norm reduction of
    the placement runs, as it would across cards."""
    from vitgan_tpu_torch.parallel.sharding import place_train_state, placement_specs

    names = dict(zip(("data", "model"), mesh.axis_names))
    plans = {}
    for net in ("g", "d"):
        shapes = {k: tuple(p.shape) for k, p in getattr(state, net).named_parameters()}
        specs = placement_specs(shapes, {"data": 2, "model": 1}, tensor_parallel,
                                "data" if fsdp else None, fsdp_min_size)
        plans[net] = {k: tuple(names[a] if a else None for a in s) for k, s in specs.items()}
    place_train_state(state, mesh, plans)


def parallel_path(work: str) -> dict:
    """[parallel] (phase 32)."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.parallel.mesh import make_mesh
    from vitgan_tpu_torch.train.step import host_metrics
    from vitgan_tpu_torch.train.trainer import Trainer

    tag, smi = "[parallel]", _smi()
    out = {"mask_rows": _mask_rows_check(),
           "note": "one card: no multi-rank run was possible (NCCL takes one rank a device); "
                   "multi-rank numerics are held on the CPU by gloo tests"}
    # depth 6 of the preset's 12 since PR 19, whose [pipeline] runs highres128 at 12
    # (the script's time); the layouts' checks do not depend on the depth
    cfg = C.replace(C.highres_config(128), **_fit_over({
        "data.dataset": "synthetic", "data.synthetic_samples": 256, "v2.depth": 6,
        "run.steps_per_epoch": 3, "run.checkpoint_every_epochs": 0}))

    def fit(name: str, place: dict = None) -> dict:
        _settle()
        torch.cuda.reset_peak_memory_stats()
        t = Trainer(cfg, run_dir=os.path.join(work, name), device="cuda",
                    fid_extractor="random_conv")
        if place:
            _place_one_way(t.state, t.mesh, **place)
        start = _flat_state(t.state)
        t.fit(epochs=2)  # 3 steps (the capture), then 3 replays
        state = _flat_state(t.state)
        fn, idx = t._device_train_fn, t._local(t.batches())
        host_metrics({"d": fn(t.state, t.dataset, idx)["d_loss"].mean()})
        _settle()  # the fit's epilogue wrote its checkpoint
        build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            m = fn(t.state, t.dataset, idx)
        host_metrics({"d": m["d_loss"].mean()})
        step_ms = 1e3 * (time.perf_counter() - t0) / (3 * len(idx))
        per_step = {k: v // (3 * len(idx)) for k, v in build.LAUNCHES.items() if v}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            host_metrics({"d": fn(t.state, t.dataset, idx)["d_loss"].mean()})
        # NCCL's kernels; at one rank its averaging all-reduce is oneRankReduce
        nccl = sorted({e.key for e in prof.key_averages()
                       if "nccl" in e.key.lower() or "onerankreduce" in e.key.lower()})
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rec = {"start": start, "state": state, "ms_per_step": step_ms, "per_step": per_step,
               "nccl_kernels": nccl, "peak_gib": peak,
               "mesh": dict(t.mesh.shape), "distributed": t.mesh.distributed}
        del t, fn
        torch.cuda.empty_cache()
        return rec

    ref = fit("none")
    if ref["nccl_kernels"]:
        raise AssertionError(f"{tag} the fit with no mesh launched {ref['nccl_kernels']}")
    store = os.path.join(work, "store")
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0, world_size=1)
    try:
        if not make_mesh(cfg.mesh).distributed:
            raise AssertionError(f"{tag} the world-1 group gave no collectives")
        runs = {"dp": fit("dp"), "fsdp": fit("fsdp", {"fsdp": True, "fsdp_min_size": 2048}),
                "tp": fit("tp", {"tensor_parallel": True})}
    finally:
        dist.destroy_process_group()
    print(f"{tag} {smi}: highres128 auto at depth 6, 3 + 3 captured steps; no mesh "
          f"{ref['ms_per_step']:.2f} ms a step, peak {ref['peak_gib']:.2f} GiB")
    out["none"] = {k: ref[k] for k in ("ms_per_step", "peak_gib")}
    for name, r in runs.items():
        if r["per_step"] != ref["per_step"]:
            diff = {k: (r["per_step"].get(k), ref["per_step"].get(k))
                    for k in set(r["per_step"]) | set(ref["per_step"])
                    if r["per_step"].get(k) != ref["per_step"].get(k)}
            raise AssertionError(f"{tag} {name}: launches a step differ from the fit with no "
                                 f"mesh: {diff}")
        if not r["nccl_kernels"]:
            raise AssertionError(f"{tag} {name}: no NCCL kernel in the captured replay")
        bit_equal = all(torch.equal(r["state"][k], v) for k, v in ref["state"].items())
        reason = None
        if not bit_equal:
            reason = ("each leaf's gradient norm is the root of its slices' squared norms "
                      "summed over the ranks (parallel/sharding.Placement.leaf_norms)")
            if name == "dp":
                raise AssertionError(f"{tag} dp: the state differs from the fit with no mesh")
            _hold_states(f"{tag} {name}", ref["start"], ref["state"], r["state"])
        print(f"{tag} {smi}: {name} mesh {r['mesh']}: {r['ms_per_step']:.2f} ms a step, peak "
              f"{r['peak_gib']:.2f} GiB, launches a step equal to no mesh's, NCCL in the "
              f"replay {r['nccl_kernels']}; state "
              + ("bit-equal to no mesh's" if bit_equal else f"within the route bounds ({reason})"))
        out[name] = {"ms_per_step": r["ms_per_step"], "peak_gib": r["peak_gib"],
                     "nccl_kernels": r["nccl_kernels"], "bit_equal": bit_equal,
                     "reason": reason, "launches_per_step": r["per_step"]}
    print(f"{tag} {out['note']}")
    return out


def _pipe_rows_check() -> dict:
    """The linear stage's dropout bits of each microbatch of G's batch (32
    samples x 1,024 tokens, E 384) at M = 2 and 4, keyed by their rows in the
    batch (ops/draws.microbatch, ops/fused_block.mask_rows), against the
    whole batch's mask: bit-equal."""
    import torch

    from vitgan_tpu_torch.ops import draws
    from vitgan_tpu_torch.ops import fused_block as FB
    from vitgan_tpu_torch.ops import fused_mlp as FM

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n, e, b = 1024, 384, 32
    x = torch.randn((b * n, e), device="cuda", generator=gen).to(torch.bfloat16)
    attn = torch.randn((b * n, e), device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randn((e, e), device="cuda", generator=gen) * e ** -0.5
    bias = torch.randn((e,), device="cuda", generator=gen) * 0.1
    seed = torch.tensor([1234567890123], dtype=torch.int64, device="cuda")
    _, whole = FM.linear_stage(attn, w, bias, x, seed, MB_RATE, 0)
    out = {}
    for m in (2, 4):
        mb = b // m
        for j in range(m):
            rows = slice(j * mb * n, (j + 1) * mb * n)
            with draws.microbatch(j * mb, b):
                key = FB.mask_rows(mb, n)
            _, mine = FM.linear_stage(attn[rows], w, bias, x[rows], seed, MB_RATE, 0, key)
            if not torch.equal(mine, whole[rows]):
                raise AssertionError(f"[pipeline] microbatch {j} of {m}: its dropout bits are "
                                     "not the whole batch's rows")
        out[f"M{m}"] = {"microbatch_rows": mb, "bits_equal": True}
    return out


def _one_stage():
    from vitgan_tpu_torch.parallel.mesh import Mesh

    return Mesh({"data": 1, "model": 1, "pipe": 1}, axis_names=("data", "model", "pipe"),
                pipe_axis="pipe")


def _forwards(trainer, seed: int) -> tuple:
    """G on a fixed latent batch and D on its images, eval mode."""
    import numpy as np
    import torch

    g, d = trainer.state.g, trainer.state.d
    z = trainer.gan.sample_latent(np.random.default_rng(seed), trainer.cfg.model.batch_size)
    with torch.inference_mode():
        imgs = g(z.to("cuda", torch.bfloat16))
        return imgs.float().cpu(), trainer.gan.discriminator_apply(d, imgs).float().cpu()


def _step_grads(trainer) -> dict:
    """One eager train step from the trainer's start state on the dataset's
    first batch: every parameter's gradient (G's from the G update, D's from
    the D update), the metrics; the start state restored in place after."""
    import numpy as np
    import torch

    from vitgan_tpu_torch.train.step import host_metrics

    st = trainer.state
    start = st.state_dict()
    m = host_metrics(trainer.train_step(st, trainer.real_batch(
        np.arange(trainer.cfg.model.batch_size))))
    grads = {f"{net}.{k}": p.grad.detach().float().cpu().clone()
             for net in ("g", "d") for k, p in getattr(st, net).named_parameters()}
    st.load_state_dict(start)
    return {"grads": grads, "metrics": m}


def _hold_grads(tag: str, want: dict, got: dict) -> float:
    """Each gradient leaf within LEAF_RTOL * its max|want| (the route bound);
    returns the largest ratio |d| / max|want| over the leaves."""
    worst = 0.0
    for k, w in want["grads"].items():
        scale = w.abs().max().item()
        d = (got["grads"][k] - w).abs().max().item()
        if not d <= LEAF_RTOL * scale:
            raise AssertionError(f"{tag} gradient {k}: max |d| {d:.3e} over "
                                 f"{LEAF_RTOL} x {scale:.3e}")
        worst = max(worst, d / scale if scale else 0.0)
    for k, v in want["metrics"].items():
        d = abs(got["metrics"][k] - v)
        if not d <= (NORM_RTOL * abs(v) if k.endswith("grad_norm") else LOSS_TOL):
            raise AssertionError(f"{tag} one step's {k}: {got['metrics'][k]} against {v}")
    return worst


def _adam_reach(beta1: float, beta2: float, steps: int) -> float:
    """The most ``steps`` Adam updates can move a parameter, in learning
    rates, whatever the gradients: at update t, |m_hat / sqrt(v_hat)| <=
    sqrt(sum_i a_i ** 2 / b_i) by Cauchy-Schwarz, a_i and b_i the bias-corrected
    weights of gradient i in m_hat and v_hat (1.00 a step at beta1 0.9, up to
    1.13 at v1's 0.5)."""
    total = 0.0
    for t in range(1, steps + 1):
        a = [(1 - beta1) * beta1 ** (t - i) / (1 - beta1 ** t) for i in range(1, t + 1)]
        b = [(1 - beta2) * beta2 ** (t - i) / (1 - beta2 ** t) for i in range(1, t + 1)]
        total += math.sqrt(sum(x * x / y for x, y in zip(a, b)))
    return total


def _adam_drift(tag: str, cfg, want: dict, got: dict, steps: int) -> float:
    """Parameters after ``steps`` Adam updates from one start: the largest
    |d| / bound over the leaves, bound twice the most those updates can move
    a parameter (:func:`_adam_reach`).  A reading and not a check: two runs
    from one start stay within it whatever their gradients (the gradients
    are held by :func:`_hold_grads`).  Raises only where a parameter is not
    finite."""
    import torch

    worst = 0.0
    m = cfg.model
    for k, w in want.items():
        if not k.startswith(("g.", "d.")) or not w.is_floating_point() or k.endswith(
                (".u", ".sigma0")):
            continue
        opt = (m.gen_optim if k.startswith("g.") else m.disc_optim) if hasattr(
            m, "gen_optim") else (m.generator if k.startswith("g.") else m.discriminator).optim
        bound = 2 * opt.learning_rate * _adam_reach(opt.beta1, opt.beta2, steps)
        if not bool(torch.isfinite(got[k]).all()):
            raise AssertionError(f"{tag} {k} after {steps} steps is not finite")
        worst = max(worst, (got[k].double() - w.double()).abs().max().item() / bound)
    return worst


def pipeline_path(work: str) -> dict:
    """[pipeline] (phase 33): highres128 at full width (depth 12, batch 32,
    remat attn, megablock auto) through a one-stage pipe
    (parallel/pipeline.pp_bundle) at M = 2 and 4 against the unpipelined
    step: one Trainer, whose modules take each bundle's runners in turn, and
    from one start state (restored in place) 3 steps of the trainer's
    captured step (make_device_data_train_fn; its first step eager, captured,
    2 replays) on the same batches, then 3 timed calls; then v1 at its
    defaults under use_pallas=always at M = 2."""
    import torch

    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.parallel.pipeline import pp_bundle
    from vitgan_tpu_torch.train.step import host_metrics, make_device_data_train_fn
    from vitgan_tpu_torch.train.trainer import Trainer

    tag, smi = "[pipeline]", _smi()
    out = {"rows": _pipe_rows_check()}
    print(f"{tag} {smi}: each microbatch's megablock dropout bits are the whole batch's rows "
          "(M = 2, 4)")

    def variants(name: str, cfg, ms: tuple, timed: bool) -> dict:
        t = Trainer(cfg, run_dir=os.path.join(work, name), device="cuda")
        st = t.state
        start_sd, start = st.state_dict(), _flat_state(st)
        idx = t._local(t.batches()[:3])
        recs = {}
        for m in ms:
            gan = t.gan
            if m:
                gan = pp_bundle(t.gan, cfg, mesh=_one_stage(), microbatches=m)
            st.g.blocks_runner = gan.blocks_runners["g"] if m else None
            st.d.blocks_runner = gan.blocks_runners["d"] if m else None
            st.load_state_dict(start_sd)
            _settle()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            rec = {"forwards": _forwards(t, SEED + 5), "one_step": _step_grads(t)}
            fn = make_device_data_train_fn(gan, cfg, len(idx))
            mm = fn(st, t.dataset, idx)
            rec["means"] = host_metrics({k: v.mean() for k, v in mm.items()})
            rec["state"] = _flat_state(st)
            if timed:
                build.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    mm = fn(st, t.dataset, idx)
                host_metrics({"d": mm["d_loss"].mean()})
                rec["ms_per_step"] = 1e3 * (time.perf_counter() - t0) / (3 * len(idx))
                rec["per_step"] = {k: v // (3 * len(idx)) for k, v in build.LAUNCHES.items()
                                   if v}
                rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            del fn, mm
            recs[m] = rec
        del t, st
        torch.cuda.empty_cache()
        return start, recs

    def hold(label: str, cfg, ref: dict, r: dict) -> dict:
        metric_diff = {}
        for k, v in ref["means"].items():
            d = abs(r["means"][k] - v)
            metric_diff[k] = d
            if not d <= (NORM_RTOL * abs(v) if k.endswith("grad_norm") else LOSS_TOL):
                raise AssertionError(f"{tag} {label} metric {k}: {r['means'][k]} against {v}")
        # the parameter gradients sum the microbatches' products (wgrad_gemm)
        # in another order than the whole batch's: one step's gradients within
        # the route bound; the parameters' drift after 3 Adam steps a reading
        return {"metric_max_abs_diff": metric_diff,
                "grad_max_rel_diff": _hold_grads(f"{tag} {label}", ref["one_step"],
                                                 r["one_step"]),
                "params_over_adam_bound": _adam_drift(f"{tag} {label}", cfg, ref["state"],
                                                      r["state"], 3),
                "forwards_max_abs_diff": [float((a - b).abs().max()) for a, b in
                                          zip(r["forwards"], ref["forwards"])]}

    cfg = C.replace(C.highres_config(128), **_fit_over({
        "data.dataset": "synthetic", "data.synthetic_samples": 256}))
    _, runs = variants("highres128", cfg, (0, 2, 4), timed=True)
    ref = runs[0]
    print(f"{tag} {smi}: highres128 auto, remat attn, 3 captured steps; unpipelined "
          f"{ref['ms_per_step']:.2f} ms a step, peak {ref['peak_gib']:.2f} GiB")
    out["none"] = {k: ref[k] for k in ("ms_per_step", "peak_gib", "per_step")}
    for m in (2, 4):
        r, name = runs[m], f"M{m}"
        for k, v in ref["per_step"].items():  # every kernel M times, at B / M rows
            if r["per_step"].get(k) != m * v:
                raise AssertionError(f"{tag} {name}: {k} launched {r['per_step'].get(k)} times a "
                                     f"step, expected {m} x {v}")
        if set(r["per_step"]) != set(ref["per_step"]):
            raise AssertionError(f"{tag} {name}: kernels {sorted(r['per_step'])} against "
                                 f"{sorted(ref['per_step'])}")
        if not all(torch.equal(a, b) for a, b in zip(r["forwards"], ref["forwards"])):
            # the kernels are row-invariant: a microbatch's rows are the batch's
            raise AssertionError(f"{tag} {name}: G / D forwards differ")
        held = hold(name, cfg, ref, r)
        print(f"{tag} {smi}: M = {m} ({32 // m} rows a microbatch): {r['ms_per_step']:.2f} ms a "
              f"step ({r['ms_per_step'] / ref['ms_per_step']:.3f}x unpipelined), peak "
              f"{r['peak_gib']:.2f} GiB; every kernel {m}x a step; G and D forwards bit-equal; "
              f"one step's gradients within {held['grad_max_rel_diff']:.2e} of each leaf's max; "
              f"parameters after 3 steps at {held['params_over_adam_bound']:.3f} of twice "
              f"Adam's reach (a reading); metrics max |d| "
              f"{max(held['metric_max_abs_diff'].values()):.3e}")
        out[name] = {"ms_per_step": r["ms_per_step"], "peak_gib": r["peak_gib"],
                     "launches_per_step": r["per_step"], "forwards_bit_equal": True, **held}
    # v1 at its defaults under use_pallas=always (the `l2` kernels in D)
    v1 = _v1_cfg(**_fit_over({}))
    _, vruns = variants("v1", v1, (0, 2), timed=False)
    held = hold("v1 M2", v1, vruns[0], vruns[2])
    print(f"{tag} {smi}: v1 use_pallas=always, M = 2: one step's gradients within "
          f"{held['grad_max_rel_diff']:.2e} of each leaf's max, 3 captured steps at "
          f"{held['params_over_adam_bound']:.3f} of twice Adam's reach (a reading); "
          f"forwards max |d| "
          f"{held['forwards_max_abs_diff']}")
    out["v1_M2"] = held
    return out


def context_path(work: str) -> dict:
    """[context] (phase 34): one seq rank in a world-1 NCCL group.
    cp_attention and ring_cp_attention at D's shape (32, 6, 1,025, 64)
    against dispatch_attention there; a v2 step at highres128's widths
    (depth 2) with the sequence-parallel policy set launches no kernel."""
    import torch
    import torch.distributed as dist

    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.ops.attention import dispatch_attention
    from vitgan_tpu_torch.ops.policy import set_sequence_parallel
    from vitgan_tpu_torch.parallel.context_parallel import cp_attention, ring_cp_attention
    from vitgan_tpu_torch.parallel.mesh import Mesh, make_mesh
    from vitgan_tpu_torch.train.state import create_train_state
    from vitgan_tpu_torch.train.step import host_metrics, make_train_step

    tag, smi = "[context]", _smi()
    out = {}
    store = os.path.join(work, "store")
    os.makedirs(work, exist_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0, world_size=1)
    try:
        mesh = make_mesh(C.MeshConfig(model_parallel=1))
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v = (torch.randn((32, 6, 1025, 64), device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
        want = dispatch_attention(q, k, v, "dot", 64.0).float()
        for name, fn in (("gather", cp_attention), ("ring", ring_cp_attention)):
            got = fn(q, k, v, mesh, axis="model", scale=64.0).float()
            err = _err(got, want, f"{tag} {name} against dispatch_attention")
            out[name] = {"max_abs_err": err}
            print(f"{tag} {smi}: {name} at D's shape, one rank: max |d| {err:.3e} against "
                  "dispatch_attention")
        world = dist.group.WORLD  # a (data, model, seq) grid of one rank
        seq = Mesh({"data": 1, "model": 1, "seq": 1}, data_group=world, model_group=world,
                   axis_names=("data", "model", "seq"), seq_axis="seq", seq_group=world)
        cfg = C.replace(C.highres_config(128), **{"v2.depth": 2})
        from vitgan_tpu_torch.models import build_gan

        gan = build_gan(cfg)
        state = create_train_state(gan, cfg, device="cuda")
        step = make_train_step(gan, cfg)
        real = torch.rand((32, 128, 128, 3), device="cuda", generator=gen) * 2 - 1
        set_sequence_parallel(seq, "data", "seq")
        try:
            build.reset_launches()
            m = host_metrics(step(state, real))
            launched = {k_: v_ for k_, v_ in build.LAUNCHES.items() if v_}
        finally:
            set_sequence_parallel(None)
        if launched:
            raise AssertionError(f"{tag} a step under the SP policy launched {launched}")
        if not all(map(math.isfinite, m.values())):
            raise AssertionError(f"{tag} the SP step's metrics {m}")
        build.reset_launches()
        host_metrics(step(state, real))
        if not any(build.LAUNCHES.values()):
            raise AssertionError(f"{tag} the same step without SP launched no kernel")
        print(f"{tag} {smi}: a v2 step (highres128 widths, depth 2) under the SP policy "
              "launched no kernel (the JAX policy's decision); without it, the kernels")
        out["sp_step"] = {"launches": {}, "metrics": m}
        del state, step
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a CUDA card",
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from vitgan_tpu_torch import config as C  # absent next to a lone chip_smoke.py: ImportError
    from vitgan_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = _smi()
    print(f"[device] {smi}; torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # The first build: `cli warmup v2` on an empty build directory, as a fresh
    # checkout has it (every source, nvcc in parallel; [cli] reports it)
    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    warmup_clean_s = _cli_warmup("clean")
    secs = build.build()  # nothing left to build: {source: 0.0}
    print(f"[build] {len(secs)} sources by `cli warmup v2` in {warmup_clean_s} s "
          f"({time.perf_counter() - t0:.1f} s wall, parallel)")
    ptxas_warnings = {}
    for name in secs:
        kernels = _ptxas_kernels(build.build_log(name))
        spilled = [k for k in kernels if k[2] or k[3]]
        ptxas_warnings[name] = _ptxas_warnings(build.build_log(name))
        print(f"  {name}: {len(kernels)} kernels, at most {max(k[1] for k in kernels)} "
              f"registers, {len(spilled)} with spills, {len(ptxas_warnings[name])} ptxas "
              "performance warnings")
        for func, regs, stores, loads in spilled:
            print(f"    {func}: {regs} registers, {stores} bytes spill stores, {loads} loads")
        for func, line in ptxas_warnings[name]:
            print(f"    {func}: {line}")
        _check_l2_ptxas(kernels, ptxas_warnings[name])

    sass = _sass_counts(build)
    records = check_kernels()
    run_dir = os.path.join(root, "build", "chip_smoke_run")
    off_dir = os.path.join(root, "build", "chip_smoke_run_megablock_off")
    train_dir = os.path.join(root, "build", "chip_smoke_train")
    v1_dir = os.path.join(root, "build", "chip_smoke_train_v1")
    v1f32_dir = os.path.join(root, "build", "chip_smoke_train_v1_f32")
    v2f32_dir = os.path.join(root, "build", "chip_smoke_v2_f32")
    eval_dir = os.path.join(root, "build", "chip_smoke_eval")
    data_dir = os.path.join(root, "build", "chip_smoke_data")
    r1_dir = os.path.join(root, "build", "chip_smoke_r1")
    interop_dir = os.path.join(root, "build", "chip_smoke_interop")
    base_dir = os.path.join(root, "build", "chip_smoke_baselines")
    p4_dir = os.path.join(root, "build", "chip_smoke_p4")
    accum_dir = os.path.join(root, "build", "chip_smoke_accum")
    sweep_dir = os.path.join(root, "build", "chip_smoke_sweep")
    par_dir = os.path.join(root, "build", "chip_smoke_parallel")
    pipe_dir = os.path.join(root, "build", "chip_smoke_pipeline")
    ctx_dir = os.path.join(root, "build", "chip_smoke_context")
    marks = [("build", time.perf_counter())]

    def mark(label: str) -> None:
        """The wall seconds of the phases since the previous mark."""
        marks.append((label, time.perf_counter()))
        print(f"[seconds] {label}: {marks[-1][1] - marks[-2][1]:.1f}")

    try:
        httpd, launches, seeded = serve_main_path(run_dir)
        try:
            routes = compare_routes(httpd)
        finally:
            httpd.shutdown()
            httpd.server_close()
        off_launches = serve_megablock_off(run_dir, off_dir, seeded)
        mark("serve")
        del httpd
        torch.cuda.empty_cache()
        records.update(check_bwd_kernels())
        records.update(check_l2_kernels())
        mark("bwd and l2 kernels")
        v1_dot = check_v1_dot_kernels()
        mb_records, mb_blocks = check_megablock_kernels()
        # LN->qkv's record is the serving shape's; the training shapes' go beside it
        records["ln_qkv_fwd"]["training"] = mb_records.pop("ln_qkv_fwd")
        records.update(mb_records)
        for name, rec in check_ln_mlp_stages().items():
            records[name].update(rec)
        gate = check_training_gate()
        mark("megablock and LN->MLP kernels, gate")
        wide_records, wide_forms = check_wide_kernels()
        records.update(wide_records)
        mark("wide kernels")
        records.update(check_f32_kernels())
        mark("f32 kernels")
        ln32 = check_f32_ln_kernels()
        records["flash_attn_fwd_f32[dot]"].update(ln32.pop("flash_attn_fwd_f32[dot]"))
        records.update(ln32)
        mark("f32 ln kernels")
        records.update(check_f32_bwd_kernels())
        mark("f32 bwd kernels")
        records["ln_mlp_fwd"]["activations"] = check_ln_mlp_activations()
        mark("ln_mlp activations")
        train_launches, train = train_main_path(train_dir, "auto")
        shutil.rmtree(train_dir, ignore_errors=True)
        off_train_launches, train_off = train_main_path(train_dir, "off")
        train["megablock_off"] = train_off
        train["deit64"] = train_deit64()
        train["routes"] = compare_train_routes()
        mark("train highres128, deit64, routes")
        train["deit64_wide"] = wide_train = train_deit64_wide()
        train["deit64_wide"]["wide_forms"] = wide_forms
        mark("train deit64 wide")
        train["gate"], train["megablock_blocks"] = gate, mb_blocks
        v1_launches, v1 = train_v1_main_path(v1_dir)
        v1_fused_launches, v1["fused"] = train_v1_fused()
        v1["routes"] = compare_v1_train_routes()
        v1["l2ref"] = l2ref_path()
        mark("v1")
        v1f32_launches, v1f32 = train_v1_f32(v1f32_dir)
        mark("train v1 f32")
        v2f32 = v2_f32_path(v2f32_dir, bf16_run_dir=run_dir)
        mark("v2 f32")
        capture = {
            "v1": captured_vs_eager(_v1_cfg(**_fit_over({})), 4, "v1 use_pallas=always"),
            "highres128": captured_vs_eager(C.replace(C.highres_config(128), **_fit_over(
                {"data.dataset": "synthetic", "data.synthetic_samples": 256})), 2,
                "highres128 megablock=auto"),
            "resume": resume_check(), "optimizer": optimizer_update()}
        mark("captured vs eager, resume, optimizer")
        evals = eval_path(eval_dir)
        mark("eval")
        data, data_launches = data_path(data_dir)
        mark("data")
        r1 = double_backward_path(r1_dir)
        int8 = int8_serve(run_dir)
        warm_launches, interop = interop_path(interop_dir)
        baselines = baselines_path(base_dir)
        mark("double backward, int8, interop, baselines")
        p4_trainer, p4, p4_start = train_p4(p4_dir)
        p4["captured_vs_eager"] = captured_vs_eager(p4_trainer.cfg, 2, "highres256p4",
                                                    trainer=p4_trainer)
        p4["routes"] = p4_against_plain(p4_trainer, p4_start)
        remat = remat_path(p4_trainer, p4_start)
        v2f32["p4"] = p4_f32_steps(p4_trainer)
        mark("highres256p4, remat, highres256p4 f32")
        del p4_trainer, p4_start
        torch.cuda.empty_cache()
        accum = grad_accum_path(accum_dir)
        bench = bench_path(p4["ms_per_step"])
        cli_rec = cli_path(warmup_clean_s)
        mark("grad accum, bench, cli")
        sweep = sweep_path(sweep_dir)
        mark("sweep")
        parallel = parallel_path(par_dir)
        mark("parallel")
        pipe = pipeline_path(pipe_dir)
        mark("pipeline")
        context = context_path(ctx_dir)
        mark("context")
    finally:
        for d in (run_dir, off_dir, train_dir, v1_dir, v1f32_dir, v2f32_dir, eval_dir, data_dir,
                  r1_dir,
                  interop_dir, base_dir, p4_dir, accum_dir, sweep_dir, par_dir, pipe_dir, ctx_dir):
            shutil.rmtree(d, ignore_errors=True)

    csrc = "vitgan_tpu_torch/ops/csrc/"
    fb = "vitgan_tpu/ops/fused_block.py"
    # The LN->MLP forms launch ln_mlp_fwd.cu's stage kernels: each form's
    # launches are its stages' on its main path, read beside its calls.
    ln_mlp = {"ln_mlp_fwd": _ln_mlp_launches(off_launches, "ln_mlp_fwd"),
              "proj_ln_mlp_fwd": _ln_mlp_launches(launches, "proj_ln_mlp_fwd"),
              "ln_mlp_train_fwd": _ln_mlp_launches(train_launches, "ln_mlp_train_fwd")}
    forms = {**ln_mlp, "megablock_bwd_mlp": _mb_mlp_launches(train_launches)}
    host_forms = {"ln_mlp_train_fwd": _ln_mlp_launches(data_launches,
                                                       "ln_mlp_train_fwd")["launches"],
                  "megablock_bwd_mlp": _mb_mlp_launches(data_launches)["launches"]}
    for name, rec in forms.items():
        print(f"[launches] {name}: {rec['launches']} stage launches in {rec['calls']} calls "
              f"({rec['stage_launches']})")
    # name: (source, TPU kernel replaced, launches on its main path); the
    # serving kernels count the serving path, the training kernels the
    # highres128 train path under the default megablock=auto
    meta = {
        "flash_attn_fwd": ("flash_attn_fwd.cu", "vitgan_tpu/ops/attention.py:252",
                           launches["flash_attn_fwd"]),
        "ln_mlp_fwd": ("ln_mlp_fwd.cu", "vitgan_tpu/ops/fused_mlp.py:133",
                       ln_mlp["ln_mlp_fwd"]["launches"]),
        "ln_qkv_fwd": ("ln_qkv_fwd.cu", f"{fb}:408", launches["ln_qkv_fwd"]),
        "proj_ln_mlp_fwd": ("ln_mlp_fwd.cu", f"{fb}:408", ln_mlp["proj_ln_mlp_fwd"]["launches"]),
        "flash_attn_bwd_fused": ("flash_attn_bwd_fused.cu", "vitgan_tpu/ops/attention.py:606",
                                 train_launches["flash_attn_bwd_fused"]),
        "flash_attn_bwd_dq": ("flash_attn_bwd_dq.cu", "vitgan_tpu/ops/attention.py:701",
                              train_launches["flash_attn_bwd_dq"]),
        "flash_attn_bwd_dkv": ("flash_attn_bwd_dkv.cu", "vitgan_tpu/ops/attention.py:727",
                               train_launches["flash_attn_bwd_dkv"]),
        "ln_mlp_train_fwd": ("ln_mlp_fwd.cu", f"{fb}:408",
                             ln_mlp["ln_mlp_train_fwd"]["launches"]),
        "megablock_bwd_mlp": ("megablock_bwd_mlp.cu", f"{fb}:700",
                              forms["megablock_bwd_mlp"]["launches"]),
        "megablock_bwd_ln1": ("megablock_bwd_ln1.cu", f"{fb}:700",
                              train_launches["megablock_bwd_ln1"]),
        "wgrad_gemm": ("wgrad_gemm.cu", f"{fb}:700", train_launches["wgrad_gemm"]),
        "sum_partials": ("wgrad_gemm.cu", f"{fb}:700", train_launches["sum_partials"]),
        # the score modes, on the v1 train path (use_pallas=always): `l2` in D;
        # its single pass under bwd_fusion=fused; `l2ref` on its own route
        "flash_attn_fwd[l2]": ("flash_attn_fwd.cu", "vitgan_tpu/ops/attention.py:252",
                               v1_launches["flash_attn_fwd[l2]"]),
        "flash_attn_fwd[l2ref]": ("flash_attn_fwd.cu", "vitgan_tpu/ops/attention.py:252",
                                  v1["l2ref"]["launches"]),
        "flash_attn_bwd_fused[l2]": ("flash_attn_bwd_fused.cu",
                                     "vitgan_tpu/ops/attention.py:606",
                                     v1_fused_launches["flash_attn_bwd_fused[l2]"]),
        "flash_attn_bwd_dq[l2]": ("flash_attn_bwd_dq.cu", "vitgan_tpu/ops/attention.py:701",
                                  v1_launches["flash_attn_bwd_dq[l2]"]),
        "flash_attn_bwd_dkv[l2]": ("flash_attn_bwd_dkv.cu", "vitgan_tpu/ops/attention.py:727",
                                   v1_launches["flash_attn_bwd_dkv[l2]"]),
    }
    # the f32 flash kernels, on the v1 f32 train path ([train v1 f32]): `dot`
    # in G, `l2` in D; the `l2` single pass under bwd_fusion=fused, `dot` dq
    # and dk/dv under two_pass (one step each), `l2ref` on its own route
    f32_routes = v1f32["routes"]
    f32_launches = {
        "flash_attn_fwd_f32[dot]": ("flash_attn_fwd_f32.cu", 252, v1f32_launches),
        "flash_attn_fwd_f32[l2]": ("flash_attn_fwd_f32.cu", 252, v1f32_launches),
        "flash_attn_fwd_f32[l2ref]": ("flash_attn_fwd_f32.cu", 252,
                                      {"flash_attn_fwd_f32[l2ref]": v1f32["l2ref"]["launches"]}),
        "flash_attn_bwd_fused_f32[dot]": ("flash_attn_bwd_fused_f32.cu", 606, v1f32_launches),
        "flash_attn_bwd_fused_f32[l2]": ("flash_attn_bwd_fused_f32.cu", 606,
                                         f32_routes["always_fused"]["launches"]),
        "flash_attn_bwd_dq_f32[l2]": ("flash_attn_bwd_dq_f32.cu", 701, v1f32_launches),
        "flash_attn_bwd_dkv_f32[l2]": ("flash_attn_bwd_dkv_f32.cu", 727, v1f32_launches),
        "flash_attn_bwd_dq_f32[dot]": ("flash_attn_bwd_dq_f32.cu", 701,
                                       f32_routes["always_two_pass"]["launches"]),
        "flash_attn_bwd_dkv_f32[dot]": ("flash_attn_bwd_dkv_f32.cu", 727,
                                        f32_routes["always_two_pass"]["launches"]),
    }
    f32_paths = {"flash_attn_bwd_fused_f32[l2]": "one v1 f32 step with bwd_fusion=fused",
                 "flash_attn_bwd_dq_f32[dot]": "one v1 f32 step with bwd_fusion=two_pass",
                 "flash_attn_bwd_dkv_f32[dot]": "one v1 f32 step with bwd_fusion=two_pass",
                 "flash_attn_fwd_f32[l2ref]": "the l2ref route in f32, one forward and backward"}
    for name, (src, line, counts) in f32_launches.items():
        meta[name] = (src, f"vitgan_tpu/ops/attention.py:{line}", counts.get(name, 0))
    # the LayerNorm family's f32 entries, on the highres128 f32 train path
    # ([v2 f32]: megablock=on, megablock_bwd=recompute, the fit's captured steps)
    f32_ln_path = (f"highres128 f32 train (megablock=on, megablock_bwd=recompute), "
                   f"{v2f32['train_recompute']['steps']} captured steps")
    for name, (src, replaces) in F32_LN_META.items():
        meta[name] = (src, replaces, v2f32["train_recompute"]["launches"].get(name, 0))
        records[name]["launches_serve_per_call"] = v2f32["serve"]["launches_per_call"].get(name)
    # the saved backward's f32 entries, on the highres128 f32 train path at its
    # preset ([v2 f32]: megablock=auto, the saved backward, the fit's captured steps)
    f32_bwd_path = (f"highres128 f32 train at its preset (megablock=auto, megablock_bwd=saved), "
                    f"{v2f32['train_saved']['steps']} captured steps")
    for name, (src, _) in F32_BWD_META.items():
        meta[name] = (src, f"{fb}:700", v2f32["train_saved"]["launches"].get(name, 0))
        records[name]["launches_deit64_per_step"] = v2f32["deit64"]["launches"].get(name, 0)
    # the wide variants, on the DeiT-B-width train path ([train deit64 wide])
    for name, (src, replaces, form) in WIDE_KERNELS.items():
        meta[name] = (src, replaces, wide_train["launches"].get(name, 0))
        records[name]["variant_of"] = form
    paths = {"flash_attn_fwd[l2]": f"v1 train, {v1['steps']} captured steps",
             "flash_attn_bwd_dq[l2]": f"v1 train, {v1['steps']} captured steps",
             "flash_attn_bwd_dkv[l2]": f"v1 train, {v1['steps']} captured steps",
             "flash_attn_bwd_fused[l2]": "v1 train with bwd_fusion=fused, 3 captured steps",
             "flash_attn_fwd[l2ref]": "the l2ref route, one forward and backward",
             **{name: f"v1 f32 train, {v1f32['steps']} captured steps" for name in F32_MAIN},
             **f32_paths, **{name: f32_ln_path for name in F32_LN_META},
             **{name: f32_bwd_path for name in F32_BWD_META},
             **{name: f"deit64 at DeiT-B width ({DEIT_B}), {WIDE_STEPS} captured steps"
                for name in WIDE_KERNELS}}
    kernels = []
    for name, (src, replaces, n_launch) in meta.items():
        if n_launch <= 0:
            raise AssertionError(f"{name} was not launched on its route")
        kernels.append({"name": name, "route": "cuda", "source": csrc + src,
                        "replaces": replaces, **records[name], **forms.get(name, {}),
                        "launches": n_launch})
        if name in paths:
            kernels[-1]["launches_path"] = paths[name]
    kernels[0]["launches_megablock_off"] = off_launches["flash_attn_fwd"]
    for k in kernels:
        if k["name"] in ("flash_attn_fwd", "ln_qkv_fwd"):
            k["launches_train"] = train_launches[k["name"]]
        if k["name"] in TRAIN_KERNELS["auto"]:
            # the highres128 train path over CIFAR-10 on the host route ([data])
            k["launches_train_host_route"] = host_forms.get(k["name"],
                                                            data_launches.get(k["name"], 0))
        if k["name"] in ("flash_attn_fwd", "flash_attn_bwd_fused", "flash_attn_bwd_dq",
                         "flash_attn_bwd_dkv"):
            k["launches_train_megablock_off"] = off_train_launches[k["name"]]
        if k["name"] == "ln_mlp_fwd":
            k["launches_train_megablock_off"] = _ln_mlp_launches(off_train_launches,
                                                                 "ln_mlp_fwd")["launches"]
        if k["name"] in sass:
            k["sass"] = sass[k["name"]]
        lib = build.SOURCE.get(k["name"], os.path.basename(k["source"])[:-3])
        warned = ptxas_warnings.get(lib, [])
        k["ptxas_warnings"] = [f"{func}: {line}" for func, line in warned]
        # phases 22-24: launches a step of R1 training on the route that runs the
        # kernel ([double backward]), of one int8 serving call ([int8 serve]) and
        # over the warm-started highres128 fit's steps ([interop])
        r1_route = {"ln_mlp_fwd": "megablock_off", "ln_qkv_fwd": "megablock_on_recompute",
                    "flash_attn_fwd": "megablock_on_recompute",
                    "ln_mlp_train_fwd": "megablock_on_recompute"}.get(k["name"])
        if r1_route:
            k["launches_r1"] = {r1_route: {
                kind: (_ln_mlp_launches(Counter(r1[r1_route][f"launches_{kind}"]),
                                        k["name"])["launches"]
                       if k["name"] in LN_MLP_STAGES else r1[r1_route][f"launches_{kind}"][
                           k["name"]]) for kind in ("with_r1", "without_r1")}}
        if k["name"] in ("flash_attn_fwd", "ln_qkv_fwd", "proj_ln_mlp_fwd"):
            q = int8["int8"]["launches"]
            k["launches_int8_serve"] = (_ln_mlp_launches(Counter(q), k["name"])["launches"]
                                        if k["name"] in LN_MLP_STAGES else q[k["name"]])
        if k["name"] in TRAIN_KERNELS["auto"]:
            k["launches_warm_start"] = {
                "ln_mlp_train_fwd": lambda: _ln_mlp_launches(Counter(warm_launches),
                                                             "ln_mlp_train_fwd")["launches"],
                "megablock_bwd_mlp": lambda: _mb_mlp_launches(Counter(warm_launches))[
                    "launches"],
            }.get(k["name"], lambda: warm_launches.get(k["name"], 0))()
        if k["name"] in pipe["M2"]["launches_per_step"]:
            # phase 33: launches a step of highres128 through a one-stage pipe
            k["launches_pipeline_per_step"] = {
                m: pipe[m]["launches_per_step"][k["name"]] for m in ("M2", "M4")}
        if k["name"] in ("flash_attn_fwd", "flash_attn_bwd_fused"):
            # the v1 generator's `dot` attention: its launches on the v1 train
            # path and the check at its shape
            k["launches_train_v1"] = v1_launches[k["name"]]
            k["v1"] = v1_dot[k["name"]]
        # phases 26-27: launches a step of the 4,096-token preset's fit
        # ([highres256p4], remat 'attn') and under each remat mode ([remat])
        stages = {"ln_mlp_fwd": ("ln_mlp_fc1", "ln_mlp_linear")}.get(k["name"], (k["name"],))
        if k["name"] in ("flash_attn_fwd", "flash_attn_bwd_fused", "ln_mlp_fwd"):
            k["launches_highres256p4_per_step"] = sum(p4["launches_per_step"].get(n, 0)
                                                      for n in stages)
        if k["name"] in ("flash_attn_fwd", "flash_attn_bwd_fused", "ln_mlp_fwd", "ln_qkv_fwd",
                         "ln_mlp_train_fwd"):
            k["launches_remat_per_step"] = {  # the wrapper's calls
                f"{preset} {mode}": r["launches_per_step"].get(k["name"], 0)
                for preset in ("highres256p4", "highres128") for mode, r in remat[preset].items()}
    print(json.dumps({"routes": routes}))
    print(json.dumps({"train": train}))
    print(json.dumps({"v1": v1}))
    print(json.dumps({"v1_f32": v1f32}, default=float))
    print(json.dumps({"v2_f32": v2f32}, default=float))
    print(json.dumps({"capture": capture}))
    print(json.dumps({"eval": evals}))
    print(json.dumps({"data": data}, default=float))
    print(json.dumps({"double_backward": r1}, default=float))
    print(json.dumps({"int8_serve": int8}, default=float))
    print(json.dumps({"interop": interop}, default=float))
    print(json.dumps({"baselines": baselines}, default=float))
    print(json.dumps({"highres256p4": p4}, default=float))
    print(json.dumps({"remat": remat}, default=float))
    print(json.dumps({"grad_accum": accum}, default=float))
    print(json.dumps({"bench": bench, "cli": cli_rec}, default=float))
    print(json.dumps({"sweep": sweep}, default=float))
    print(json.dumps({"parallel": parallel}, default=float))
    print(json.dumps({"pipeline": pipe, "context": context}, default=float))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
