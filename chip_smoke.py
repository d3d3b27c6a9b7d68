#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (vitgan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Fails unless torch.cuda.is_available(); prints the card's name and power
   limit as nvidia-smi gives them.
2. Builds the hand-written CUDA kernels from vitgan_tpu_torch/ops/csrc, all
   sources in parallel, timed.
3. Holds every kernel against its plain PyTorch version on the same bf16
   inputs on the card: at the serving shapes of highres128 at batch 64, at a
   ragged shape (N 257, E 192, 3 heads) and, for flash attention, at one long
   sequence (B*H 1, N 16,385).  Times kernel, plain version and, where one
   PyTorch call computes the same function, that call (library_ms).
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
   (1, 1, 16385, 64) shape, each output within 2e-2 of its own max|plain|;
   times each beside its bound, its plain version and PyTorch's
   scaled_dot_product_attention backward (library_ms).
8. Under the default runtime.megablock=auto, a highres128 training block on
   the card raises naming ROADMAP.md: the JAX package's gate routes it
   through the megablock's training kernels, which are not ported.
9. Trains highres128 with runtime.megablock=off through Trainer (the entry
   point of `cli train`) on a 256-sample synthetic dataset at batch 32 in
   bf16 with dropout 0.1 and DiffAugment color,translation: 2 warm-up steps,
   then 5 timed steps by Trainer.fit, whose kernel launches per step must be
   flash forward 36, single-pass backward 12, dq 24, dk/dv 24, LN->MLP 36 and
   LN->qkv 0.  The losses must be finite and the parameters must have moved;
   torch.profiler splits 2 more steps' device time by kernel group.  The run
   directory fit writes is restored by restore_run, answers one
   `cli generate` and one HTTP request of the server `cli serve` starts.
10. Runs one megablock=off train step at full width and batch 8, dropout 0,
   with the same state, batch, latents and augment draws, on the kernel route
   and on use_pallas=never, and holds losses, gradient norms and every
   gradient leaf of the two against each other.

Any failed check raises.  The second-to-last lines are a {"kernels": [...]}
JSON object and nvidia-smi's name/power line; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import io
import json
import math
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


def check_kernels() -> dict:
    """Kernel vs plain version at the serving shapes (timed), the ragged shape
    and one long sequence.  Returns {name: record} for the JSON line."""
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
        for name, (kern, plain, library, (bound_ms, bound_by), residual) in calls.items():
            err = _err(kern(), plain(), f"{name} {label}", residual)
            if label == "ragged":
                out[name]["ragged_max_abs_err"] = err
                continue
            if name == "flash_attn_fwd":  # the LSE the backward will read
                s = torch.einsum("bhnd,bhmd->bhnm", c["q"].float(), c["k"].float()) / math.sqrt(dh)
                lse_err = (A.flash_forward(c["q"], c["k"], c["v"], float(dh))[1]
                           - torch.logsumexp(s, -1)).abs().max().item()
                del s
                print(f"  flash_attn_fwd lse: max_abs_err {lse_err:.6g} (tolerance 1e-2)")
                if not lse_err <= 1e-2:
                    raise AssertionError("flash LSE disagrees with logsumexp")
            rec = {"max_abs_err": err, "ms": _time_ms(kern, 20), "plain_ms": _time_ms(plain, 5),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": _time_ms(library, 20) if library else None}
            print(f"  {name}: {rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f} ms, "
                  f"library {rec['library_ms']}, bound {bound_ms:.4f} ms by {bound_by})")
            out[name] = rec
        del c, x2, calls
        torch.cuda.empty_cache()

    # One long sequence: where the TPU kernel switches to streaming K/V from
    # HBM (attention.py:179); here the same kernel streams at every length.
    q, k, v = (torch.randn((1, 1, 16385, 64), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    print("[kernels] long: B*H 1 N 16385 Dh 64")
    out["flash_attn_fwd"]["long_seq_max_abs_err"] = _err(
        A.flash_forward(q, k, v, 64.0)[0], A.attention_reference(q, k, v, "dot", 64.0),
        "flash_attn_fwd long")
    out["flash_attn_fwd"]["long_seq_ms"] = _time_ms(lambda: A.flash_forward(q, k, v, 64.0), 5)
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
        _check_launches(launches, ("ln_qkv_fwd", "flash_attn_fwd", "proj_ln_mlp_fwd"),
                        m.depth * calls)
        return httpd, launches, arr
    except BaseException:
        httpd.shutdown()
        httpd.server_close()
        raise


def _check_launches(launches: dict, route: tuple, expected: int) -> None:
    """The route's kernels launched ``expected`` times each, no other kernel."""
    for name, n in launches.items():
        want = expected if name in route else 0
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
    _check_launches(launches, ("flash_attn_fwd", "ln_mlp_fwd"), cfg.v2.depth * calls)
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
            bound_ms, bound_by = _bound(2.0 * products * b * h * n * n * dh,
                                        (5 + writes) * elem + b * h * n * 4)
            rec = {"max_abs_err": err, "ms": _time_ms(lambda: kern(*args), 5 if n > 8192 else 20),
                   "plain_ms": _time_ms(lambda: plain(*args), 2), "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": library_ms}
            torch.cuda.empty_cache()
            print(f"  {name} {label}: {rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f} ms, SDPA "
                  f"backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by})")
            if label == BWD_MAIN_SHAPE[name]:
                out[name].update(rec)
            else:
                out[name][f"{label}_max_abs_err"] = err
                out[name][f"{label}_ms"] = rec["ms"]
        del q, k, v, do, o, lse, qg, kg, vg, sdpa_out, library
        torch.cuda.empty_cache()
    return out


TRAIN = "[train megablock=off]"
TRAIN_KERNELS = {"flash_attn_fwd": 36, "flash_attn_bwd_fused": 12, "flash_attn_bwd_dq": 24,
                 "flash_attn_bwd_dkv": 24, "ln_mlp_fwd": 36}


def check_training_gate() -> None:
    """Under the default runtime.megablock=auto the JAX package's gate sends
    highres128's training blocks (G's 1,024 tokens, D's 1,025) through the
    megablock's training kernels; on the card the port raises there, naming
    ROADMAP.md, and takes no other path."""
    import torch

    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.models.vitgan_v2 import EncoderBlock
    from vitgan_tpu_torch.ops.fused_block import maybe_megablock
    from vitgan_tpu_torch.ops.policy import get_policy, set_policy

    cfg = C.highres_config(128)
    m = cfg.v2
    with torch.device("meta"):
        block = EncoderBlock(m, None)
    saved = get_policy()
    try:
        set_policy(mode="auto", megablock="auto")
        for n in (1024, 1025):
            x = torch.empty((m.batch_size, n, m.embed_dim), dtype=torch.bfloat16, device="cuda")
            try:
                maybe_megablock(block, x, m, train=True)
            except NotImplementedError as e:
                if "ROADMAP.md" not in str(e):
                    raise
                print(f"[train gate] megablock=auto, N {n}: raises: {e}")
            else:
                raise AssertionError(f"megablock=auto took a path for a training block, N {n}")
        set_policy(megablock="off")
        if maybe_megablock(block, x, m, train=True) is not None:
            raise AssertionError("megablock=off routed a training block")
    finally:
        set_policy(mode=saved["mode"], megablock=saved["megablock"])


def train_main_path(run_dir: str) -> tuple:
    """highres128 with runtime.megablock=off through Trainer: 2 warm-up
    steps, 5 timed steps by fit, the run directory restored and one
    `cli generate`."""
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

    steps = 5
    cfg = C.replace(C.highres_config(128), **{
        "data.dataset": "synthetic", "data.synthetic_samples": 256, "run.epochs": 1,
        "run.steps_per_epoch": steps, "run.log_every_steps": 0, "runtime.megablock": "off"})
    m = cfg.v2
    t0 = time.perf_counter()
    trainer = Trainer(cfg, run_dir=run_dir, device="cuda")
    st = trainer.state
    print(f"{TRAIN} highres128: batch {m.batch_size}, {cfg.runtime.compute_dtype}, dropout "
          f"{m.dropout}, augment {cfg.run.diff_augment!r}, loss {m.loss}; G {count_params(st.g)} "
          f"D {count_params(st.d)} parameters; set up in {time.perf_counter() - t0:.1f} s")
    before = [p.detach().cpu().clone() for p in (*st.g.parameters(), *st.d.parameters())]
    t0 = time.perf_counter()
    for idx in trainer.batches()[:2]:  # warm-up
        warm = host_metrics(trainer.train_step(st, trainer.real_batch(idx)))
    print(f"{TRAIN} 2 warm-up steps in {time.perf_counter() - t0:.2f} s: {warm}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    # --- the main path ---
    means = trainer.fit()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    # --- end of the main path ---
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    img_s = means["images_per_sec"]  # fit's clock: the steps and the epoch's metric readback
    ms = 1e3 * m.batch_size / img_s
    print(f"{TRAIN} {steps} steps by Trainer.fit: {ms:.1f} ms/step, {img_s:.2f} img/s "
          f"({sec:.3f} s with the run directory's write), peak {peak / 2**30:.2f} GiB allocated")
    print(f"{TRAIN} epoch means: {means}")
    print(f"{TRAIN} launches over {steps} steps: {launches}")
    for name, n in launches.items():
        want = TRAIN_KERNELS.get(name, 0) * steps
        if n != want:
            raise AssertionError(f"train step: {name} launched {n} times, expected {want}")
    if not all(math.isfinite(means[k]) for k in ("d_loss", "g_loss", "d_grad_norm",
                                                 "g_grad_norm")):
        raise AssertionError(f"non-finite train metrics: {means}")
    after = [p.detach().cpu() for p in (*st.g.parameters(), *st.d.parameters())]
    moved = sum(not torch.equal(a, b) for a, b in zip(before, after))
    print(f"{TRAIN} {moved} of {len(after)} parameter tensors moved")
    if moved != len(after):
        raise AssertionError("some parameters did not move")
    del before, after
    breakdown = train_breakdown(trainer, ms)
    del trainer, st
    torch.cuda.empty_cache()
    rcfg, _, g, meta = restore_run(run_dir, device="cuda")
    if meta.get("step") != 2 + steps or rcfg.v2 != m:
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
    print(f"{TRAIN} restored step {meta['step']} and `cli generate` wrote a {h}x{w} grid")
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
    print(f"{TRAIN} the trained run directory served POST npy n=4 in {req_ms:.1f} ms")
    return launches, {"ms_per_step": ms, "img_per_s": img_s, "peak_allocated_bytes": peak,
                      "means": means, "breakdown": breakdown}


# Kernel names of the port, by the substring of their CUDA symbol.
PORT_KERNELS = (("flash_bwd_kv_kernel", "flash backward k-block (single-pass or dk/dv)"),
                ("flash_bwd_dq_kernel", "flash backward dq"),
                ("scale_cast_kernel", "flash single-pass dq scale-and-cast"),
                ("flash_attn_fwd_kernel", "flash forward"), ("ln_mlp", "LN->MLP forward"))


def _kernel_group(name: str) -> str:
    for key, label in PORT_KERNELS:
        if key in name:
            return label
    low = name.lower()
    if "gemm" in low or "xmma" in low or "cutlass" in low or "sm90" in low:
        return "library matrix products (cuBLAS/CUTLASS)"
    if "multi_tensor" in low or "adam" in low:
        return "optimizer"
    return "other elementwise and reductions"


def train_breakdown(trainer, step_ms: float) -> dict:
    """Where a train step's device time goes: torch.profiler over 2 steps,
    kernel time summed by group, and the device's idle share of the wall
    time; then the LN->MLP recompute backward alone at the step's three row
    counts: the autograd Function's backward as the port runs it (the plain
    forward recomputed and differentiated, TF32 products), and the same
    forward and backward of the plain version in full f32."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vitgan_tpu_torch.ops import fused_mlp as FM

    st = trainer.state
    batches = trainer.batches()[:2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for idx in batches:
            trainer.train_step(st, trainer.real_batch(idx))
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / len(batches)
    rows = [(e.key, e.self_device_time_total / 1e3 / len(batches), e.count // len(batches))
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    out = {"profiled_wall_ms_per_step": wall_ms}
    if not rows or sum(r[1] for r in rows) == 0:
        print("[breakdown] the profiler recorded no device time: not measured")
    else:
        busy = sum(r[1] for r in rows)
        groups: dict = {}
        for name, t, _ in rows:
            groups[_kernel_group(name)] = groups.get(_kernel_group(name), 0.0) + t
        print(f"[breakdown] per step under the profiler: wall {wall_ms:.1f} ms, device busy "
              f"{busy:.1f} ms; idle {100 * (1 - busy / step_ms):.1f}% of the unprofiled "
              f"{step_ms:.1f} ms step ({100 * (1 - busy / wall_ms):.1f}% of the profiled one)")
        for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"  {g}: {t:.2f} ms ({100 * t / busy:.1f}%)")
        print("[breakdown] top kernels per step (ms, launches):")
        for name, t, n in sorted(rows, key=lambda r: -r[1])[:15]:
            print(f"  {t:8.3f} ms {n:5d}  {name[:110]}")
        out.update({"device_busy_ms_per_step": busy, "idle_share": 1 - busy / step_ms,
                    "idle_share_profiled": 1 - busy / wall_ms, "groups_ms_per_step": groups})
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
    """One megablock=off step at full width, batch 8, dropout 0, from the same
    state, batch, latents and augment draws, on the kernel route and on
    use_pallas=never."""
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

    cfg = C.replace(C.highres_config(128), **{"v2.batch_size": 8, "v2.dropout": 0.0,
                                              "runtime.megablock": "off"})
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
    try:
        for route, mode in (("kernels", "auto"), ("plain", "never")):
            set_policy(mode=mode, megablock="off")
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
            del state, step
            torch.cuda.empty_cache()
    finally:
        set_policy(mode=saved["mode"], megablock=saved["megablock"])
    (mk, gk, names), (mp, gp, _) = res["kernels"], res["plain"]
    out = {}
    for key in ("d_loss", "g_loss"):
        out[key] = abs(mk[key] - mp[key])
        print(f"[train routes] {key}: kernels {mk[key]:.6f} plain {mp[key]:.6f} "
              f"(|d| {out[key]:.3g}, tolerance {LOSS_TOL})")
        if not out[key] <= LOSS_TOL:
            raise AssertionError(f"{key} differs between the routes")
    for key in ("d_grad_norm", "g_grad_norm"):
        out[key] = abs(mk[key] - mp[key]) / mp[key]
        print(f"[train routes] {key}: kernels {mk[key]:.6f} plain {mp[key]:.6f} "
              f"(relative {out[key]:.3g}, tolerance {NORM_RTOL})")
        if not out[key] <= NORM_RTOL:
            raise AssertionError(f"{key} differs between the routes")
    worst, worst_name = 0.0, ""
    for name, a, b in zip(names, gk, gp):
        rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        if not math.isfinite(rel) or rel > worst:
            worst, worst_name = rel, name
    out["worst_leaf_rel"], out["worst_leaf"] = worst, worst_name
    print(f"[train routes] {len(names)} gradient leaves: worst max|d| / max|plain| {worst:.4g} "
          f"at {worst_name} (tolerance {LEAF_RTOL})")
    if not worst <= LEAF_RTOL:
        raise AssertionError("a gradient leaf differs between the routes")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a CUDA card",
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from vitgan_tpu_torch.ops import build  # absent next to a lone chip_smoke.py: ImportError

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = _smi()
    print(f"[device] {smi}; torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    secs = build.build()
    print(f"[build] {secs} ({time.perf_counter() - t0:.1f} s wall, parallel)")
    for name in secs:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    records = check_kernels()
    run_dir = os.path.join(root, "build", "chip_smoke_run")
    off_dir = os.path.join(root, "build", "chip_smoke_run_megablock_off")
    train_dir = os.path.join(root, "build", "chip_smoke_train")
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
        check_training_gate()
        train_launches, train = train_main_path(train_dir)
        train["routes"] = compare_train_routes()
    finally:
        for d in (run_dir, off_dir, train_dir):
            shutil.rmtree(d, ignore_errors=True)

    csrc = "vitgan_tpu_torch/ops/csrc/"
    meta = {
        "flash_attn_fwd": ("flash_attn_fwd.cu", "vitgan_tpu/ops/attention.py:252",
                           launches["flash_attn_fwd"]),
        "ln_mlp_fwd": ("ln_mlp_fwd.cu", "vitgan_tpu/ops/fused_mlp.py:133",
                       off_launches["ln_mlp_fwd"]),
        "ln_qkv_fwd": ("ln_qkv_fwd.cu", "vitgan_tpu/ops/fused_block.py:408",
                       launches["ln_qkv_fwd"]),
        "proj_ln_mlp_fwd": ("ln_mlp_fwd.cu", "vitgan_tpu/ops/fused_block.py:408",
                            launches["proj_ln_mlp_fwd"]),
        "flash_attn_bwd_fused": ("flash_attn_bwd_fused.cu", "vitgan_tpu/ops/attention.py:606",
                                 train_launches["flash_attn_bwd_fused"]),
        "flash_attn_bwd_dq": ("flash_attn_bwd_dq.cu", "vitgan_tpu/ops/attention.py:701",
                              train_launches["flash_attn_bwd_dq"]),
        "flash_attn_bwd_dkv": ("flash_attn_bwd_dkv.cu", "vitgan_tpu/ops/attention.py:727",
                               train_launches["flash_attn_bwd_dkv"]),
    }
    kernels = []
    for name, (src, replaces, n_launch) in meta.items():
        if n_launch <= 0:
            raise AssertionError(f"{name} was not launched on its route")
        kernels.append({"name": name, "route": "cuda", "source": csrc + src,
                        "replaces": replaces, "launches": n_launch, **records[name]})
    kernels[0]["launches_megablock_off"] = off_launches["flash_attn_fwd"]
    for k in kernels:
        if k["name"] in ("flash_attn_fwd", "ln_mlp_fwd"):
            k["launches_train"] = train_launches[k["name"]]
    print(json.dumps({"routes": routes}))
    print(json.dumps({"train": train}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
