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
   the discriminator's (64, 6, 1025, 64), a ragged (2, 3, 257, 64) and a long
   (1, 1, 16385, 64) shape, each output within 2e-2 of its own max|plain|
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
# HGMMA (wgmma) and UTMALDG (TMA tensor load) instructions.
HOPPER_SOURCES = ("wgrad_gemm", "flash_attn_bwd_fused", "flash_attn_bwd_dkv", "flash_attn_fwd",
                  "flash_attn_bwd_dq", "ln_mlp_fwd", "megablock_bwd_mlp", "ln_qkv_fwd",
                  "megablock_bwd_ln1")
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
        out[name] = {"HGMMA": sass.count("HGMMA"), "UTMALDG": sass.count("UTMALDG")}
        print(f"[sass] {name}: {out[name]['HGMMA']} HGMMA, {out[name]['UTMALDG']} UTMALDG")
        if not (out[name]["HGMMA"] and out[name]["UTMALDG"]):
            raise AssertionError(f"{name} holds no wgmma or no TMA load in its SASS")
        for func, body in re.findall(r"Function : (\S+)(.*?)(?=Function : |\Z)", sass, re.S):
            if any(k in func for k in L2_KERNELS):
                out[func] = {"HGMMA": body.count("HGMMA")}
                print(f"[sass]   {func}: {out[func]['HGMMA']} HGMMA")
                if not out[func]["HGMMA"]:
                    raise AssertionError(f"{func} holds no wgmma in its SASS")
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
              ("long", (1, 1, 16385, 64)))
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
}


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
    launches = _check_fit_launches(tag, launches, TRAIN_KERNELS[route], steps, grid)
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
    import shutil as _sh
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
    try:
        trainer = Trainer(cfg, run_dir=run_dir, device="cuda")
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
        _sh.rmtree(run_dir, ignore_errors=True)
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
                ("ln_qkv", "LN->qkv forward"),
                ("megablock_bwd_mlp", "megablock backward, MLP half"),
                ("megablock_bwd_ln1", "megablock backward, LN1 half"),
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
    try:
        for route, policy, must_launch in routes:
            set_policy(**policy)
            state = create_train_state(gan, cfg, device="cuda")
            step = make_train_step(gan, cfg)
            build.reset_launches()
            t0 = time.perf_counter()
            metrics = host_metrics(step(state, real, z=z, draws=draws))
            sec = time.perf_counter() - t0
            res[route] = (metrics, [p.grad.float() for p in (*state.g.parameters(),
                                                             *state.d.parameters())],
                          [f"g.{n}" for n, _ in state.g.named_parameters()]
                          + [f"d.{n}" for n, _ in state.d.named_parameters()])
            print(f"[train routes] {route}: {sec:.2f} s, launches {dict(build.LAUNCHES)}, "
                  f"metrics {metrics}")
            if route == "plain" and any(build.LAUNCHES.values()):
                raise AssertionError("the plain route launched a kernel")
            if must_launch and build.LAUNCHES[must_launch] != 36:
                raise AssertionError(f"{route}: {must_launch} did not run in every block")
            del state, step
            torch.cuda.empty_cache()
    finally:
        set_policy(**saved)
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
    import shutil as _sh
    import tempfile

    import torch

    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.train.step import host_metrics
    from vitgan_tpu_torch.train.trainer import Trainer

    cfg = _v1_cfg(**_fit_over({"run.steps_per_epoch": steps, "run.epochs": 2,
                               "runtime.bwd_fusion": "fused"}))
    run_dir = tempfile.mkdtemp(prefix="v1_fused_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        trainer = Trainer(cfg, run_dir=run_dir, device="cuda")
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
        _sh.rmtree(run_dir, ignore_errors=True)
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
        g_, s0 = got[name], start[name]
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


def captured_vs_eager(cfg, n: int, label: str) -> dict:
    """[captured vs eager]: from one state (after one eager step, so that the
    optimizer's state exists), one batch order, one latent block and one
    generator state, ``n`` steps of a captured make_device_data_train_fn
    against ``n`` eager make_train_step calls; the function is captured
    first on the same state, which is then restored in place (the
    checkpoint's restore), so that all n of its steps are replays.  Every
    leaf in the route comparison's terms; metrics: losses within LOSS_TOL,
    norms within NORM_RTOL."""
    import shutil as _sh
    import tempfile

    import numpy as np
    import torch

    from vitgan_tpu_torch.train.sample import latent_block
    from vitgan_tpu_torch.train.step import host_metrics, make_device_data_train_fn
    from vitgan_tpu_torch.train.trainer import Trainer

    tag = f"[captured vs eager] {label}"
    run_dir = tempfile.mkdtemp(prefix="cve_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        trainer = Trainer(cfg, run_dir=run_dir, device="cuda")
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
        _sh.rmtree(run_dir, ignore_errors=True)
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


def compare_v1_train_routes(batch: int = 8, diagnose: bool = False) -> dict:
    """One v1 step at the reference widths, dropout 0, from the same state,
    batch and latents on use_pallas=always with bwd_fusion auto (D's `l2`
    two-pass) and fused, and on use_pallas=never; each kernel route (bf16)
    held to the plain route in f32, the ISR u buffers included, and the bf16
    plain route's own distance printed beside.  Under use_pallas=auto the
    step launches no kernel.

    Losses, gradient norms and every leaf of more than one element are held
    as v2's are: max|d| within LEAF_RTOL of the leaf's max|plain|.  A scalar
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
    saved, kernel_bwd = get_policy(), A.flash_backward
    always, fused = dict(mode="always", bwd_fusion="auto"), dict(mode="always", bwd_fusion="fused")
    plain = dict(mode="never", bwd_fusion="auto")
    routes = [("always", always, "bfloat16", None), ("always_fused", fused, "bfloat16", None),
              ("plain", plain, "bfloat16", None), ("plain_f32", plain, "float32", None),
              ("auto", dict(mode="auto", bwd_fusion="auto"), "bfloat16", None)]
    if diagnose:
        routes += [("plain_bwd_bf16_dS", always, "bfloat16", A.flash_bwd_fused_reference),
                   ("plain_bwd_f32_dS", always, "bfloat16", _flash_bwd_f32_ds)]
    res = {}
    try:
        apply_from_runtime(cfg.runtime)
        for route, policy, dtype, backward in routes:
            set_policy(**policy)
            A.flash_backward = backward or kernel_bwd
            rcfg = C.replace(cfg, **{"runtime.compute_dtype": dtype})
            state = create_train_state(gan, rcfg, device="cuda")
            step = make_train_step(gan, rcfg)
            build.reset_launches()
            if route == "plain_f32":
                with _ScalarTerms(state) as terms:
                    metrics = host_metrics(step(state, real, z=z))
            else:
                metrics = host_metrics(step(state, real, z=z))
            launched = {k: n for k, n in build.LAUNCHES.items() if n}
            print(f"[v1 routes] {route} ({dtype}): launches {launched}, metrics {metrics}")
            res[route] = (metrics,
                          [p.grad.float() for p in (*state.g.parameters(), *state.d.parameters())],
                          [f"g.{n}" for n, _ in state.g.named_parameters()]
                          + [f"d.{n}" for n, _ in state.d.named_parameters()],
                          {n: b.float() for n, b in state.d.named_buffers() if n.endswith(".u")})
            if policy["mode"] != "always" and launched:
                raise AssertionError(f"the v1 step on use_pallas={policy['mode']} launched "
                                     f"{launched}")
            l2_bwd = ("flash_attn_bwd_fused[l2]" if route == "always_fused"
                      else "flash_attn_bwd_dq[l2]")
            if backward is None and policy["mode"] == "always" and build.LAUNCHES[l2_bwd] != 8:
                raise AssertionError(f"{route}: {l2_bwd} did not run in every D block")
            del state, step
            torch.cuda.empty_cache()
    finally:
        set_policy(**saved)
        A.flash_backward = kernel_bwd
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
        r = out[route] = {}
        checked = route in ("always", "always_fused")  # the others are reported, not held
        for key in ("d_loss", "g_loss"):
            r[key] = abs(mk[key] - mp[key])
            print(f"[v1 routes] {route} {key}: {mk[key]:.6f}, plain f32 {mp[key]:.6f} "
                  f"(|d| {r[key]:.3g}, tolerance {LOSS_TOL})")
            if checked and not r[key] <= LOSS_TOL:
                failed.append(f"{route}: {key} differs from the plain route")
        for key in ("d_grad_norm", "g_grad_norm"):
            r[key] = abs(mk[key] - mp[key]) / mp[key]
            print(f"[v1 routes] {route} {key}: {mk[key]:.6f}, plain f32 {mp[key]:.6f} "
                  f"(relative {r[key]:.3g}, tolerance {NORM_RTOL})")
            if checked and not r[key] <= NORM_RTOL:
                failed.append(f"{route}: {key} differs from the plain route")
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
              f"{worst_s} (median {r['median_scalar_rel_terms']:.4g}; tolerance {LEAF_RTOL}"
              f"{'' if checked else '; reported, not held'}); a scalar alone at most "
              f"{r['worst_scalar_alone_rel']:.4g} of itself")
        if checked and not (wide[worst] <= LEAF_RTOL and by_terms[worst_s] <= LEAF_RTOL):
            failed.append(f"{route}: a gradient leaf differs from the plain route")
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
        raise AssertionError(f"v1 routes at batch {batch}: " + "; ".join(failed))
    return out


def l2ref_path() -> dict:
    """The `l2ref` route: an ISR attention of the v1 discriminator's width
    (432, 4 heads of 108) on 256 x 50 tokens under use_pallas=always,
    forward and backward.  The forward kernel launches once; the backward is
    autograd of the plain chunked recompute, as the JAX package's `_bwd`
    (vitgan_tpu/ops/attention.py:861-870): no backward kernel launches.  The
    gradients are held to autograd through the plain attention."""
    import torch

    from vitgan_tpu_torch.models import layers as L
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.ops.policy import get_policy, set_policy

    msha = L.MHSA(432, 4, torch.Generator().manual_seed(SEED), qkv_bias=False, init="torch",
                  spectral=True).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    x = torch.randn((256, 50, 432), generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn((256, 50, 432), generator=gen, device="cuda").to(torch.bfloat16)
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
            print(f"[l2ref] {route}: launches {launched}")
            want = {"flash_attn_fwd[l2ref]": 1} if route == "kernel" else {}
            if launched != want:
                raise AssertionError(f"l2ref {route} route launched {launched}, expected {want}")
            if route == "kernel":
                launches = launched["flash_attn_fwd[l2ref]"]
    finally:
        set_policy(**saved)
    worst = max((a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
                for a, b in zip(grads["kernel"], grads["plain"]))
    print(f"[l2ref] dx and dqkv within {worst:.4g} of their max|plain| (tolerance {LEAF_RTOL})")
    if not worst <= LEAF_RTOL:
        raise AssertionError("the l2ref route's gradients differ from the plain route's")
    return {"launches": launches, "worst_grad_rel": worst}


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
    per_step = _check_fit_launches(tag, launches, TRAIN_KERNELS["auto"], DATA_STEPS, grid)
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
    blocks = cfg.v2.depth * 3
    for kind, per in launches.items():
        _check_launches(per, R1_KERNELS[label], blocks + (cfg.v2.depth if kind else 0))
    rec = {"captured_ms_with_r1": sum(captured[True]) / 3,
           "captured_ms_without_r1": sum(captured[False]) / 3,
           "eager_ms_with_r1": sum(eager[True]) / 2, "eager_ms_without_r1": sum(eager[False]) / 2,
           "d_r1": d_r1, "launches_with_r1": launches[True],
           "launches_without_r1": launches[False]}
    print(f"{tag}: captured {rec['captured_ms_with_r1']:.2f} ms with R1, "
          f"{rec['captured_ms_without_r1']:.2f} without; eager {rec['eager_ms_with_r1']:.2f} / "
          f"{rec['eager_ms_without_r1']:.2f}; d_r1 {d_r1}; launches a step with R1 "
          f"{launches[True]}, without {launches[False]}")
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
    per_step = _check_fit_launches("[interop]", launches, TRAIN_KERNELS["auto"], 2 * steps, grid)
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

    t0 = time.perf_counter()
    secs = build.build()
    print(f"[build] {secs} ({time.perf_counter() - t0:.1f} s wall, parallel)")
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
    eval_dir = os.path.join(root, "build", "chip_smoke_eval")
    data_dir = os.path.join(root, "build", "chip_smoke_data")
    r1_dir = os.path.join(root, "build", "chip_smoke_r1")
    interop_dir = os.path.join(root, "build", "chip_smoke_interop")
    base_dir = os.path.join(root, "build", "chip_smoke_baselines")
    try:
        httpd, launches, seeded = serve_main_path(run_dir)
        try:
            routes = compare_routes(httpd)
        finally:
            httpd.shutdown()
            httpd.server_close()
        off_launches = serve_megablock_off(run_dir, off_dir, seeded)
        del httpd
        torch.cuda.empty_cache()
        records.update(check_bwd_kernels())
        records.update(check_l2_kernels())
        v1_dot = check_v1_dot_kernels()
        mb_records, mb_blocks = check_megablock_kernels()
        # LN->qkv's record is the serving shape's; the training shapes' go beside it
        records["ln_qkv_fwd"]["training"] = mb_records.pop("ln_qkv_fwd")
        records.update(mb_records)
        for name, rec in check_ln_mlp_stages().items():
            records[name].update(rec)
        gate = check_training_gate()
        train_launches, train = train_main_path(train_dir, "auto")
        shutil.rmtree(train_dir, ignore_errors=True)
        off_train_launches, train_off = train_main_path(train_dir, "off")
        train["megablock_off"] = train_off
        train["deit64"] = train_deit64()
        train["routes"] = compare_train_routes()
        train["gate"], train["megablock_blocks"] = gate, mb_blocks
        v1_launches, v1 = train_v1_main_path(v1_dir)
        v1_fused_launches, v1["fused"] = train_v1_fused()
        v1["routes"] = compare_v1_train_routes()
        v1["l2ref"] = l2ref_path()
        capture = {
            "v1": captured_vs_eager(_v1_cfg(**_fit_over({})), 4, "v1 use_pallas=always"),
            "highres128": captured_vs_eager(C.replace(C.highres_config(128), **_fit_over(
                {"data.dataset": "synthetic", "data.synthetic_samples": 256})), 2,
                "highres128 megablock=auto"),
            "resume": resume_check(), "optimizer": optimizer_update()}
        evals = eval_path(eval_dir)
        data, data_launches = data_path(data_dir)
        r1 = double_backward_path(r1_dir)
        int8 = int8_serve(run_dir)
        warm_launches, interop = interop_path(interop_dir)
        baselines = baselines_path(base_dir)
    finally:
        for d in (run_dir, off_dir, train_dir, v1_dir, eval_dir, data_dir, r1_dir, interop_dir,
                  base_dir):
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
    paths = {"flash_attn_fwd[l2]": f"v1 train, {v1['steps']} captured steps",
             "flash_attn_bwd_dq[l2]": f"v1 train, {v1['steps']} captured steps",
             "flash_attn_bwd_dkv[l2]": f"v1 train, {v1['steps']} captured steps",
             "flash_attn_bwd_fused[l2]": "v1 train with bwd_fusion=fused, 3 captured steps",
             "flash_attn_fwd[l2ref]": "the l2ref route, one forward and backward"}
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
        warned = ptxas_warnings.get(os.path.basename(k["source"])[:-3], [])
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
        if k["name"] in ("flash_attn_fwd", "flash_attn_bwd_fused"):
            # the v1 generator's `dot` attention: its launches on the v1 train
            # path and the check at its shape
            k["launches_train_v1"] = v1_launches[k["name"]]
            k["v1"] = v1_dot[k["name"]]
    print(json.dumps({"routes": routes}))
    print(json.dumps({"train": train}))
    print(json.dumps({"v1": v1}))
    print(json.dumps({"capture": capture}))
    print(json.dumps({"eval": evals}))
    print(json.dumps({"data": data}, default=float))
    print(json.dumps({"double_backward": r1}, default=float))
    print(json.dumps({"int8_serve": int8}, default=float))
    print(json.dumps({"interop": interop}, default=float))
    print(json.dumps({"baselines": baselines}, default=float))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
