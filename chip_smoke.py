#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py          # from the repository root, one H100

Phases, one JSON line each (and a ``phase_seconds`` line after each);
any failure raises and exits non-zero:

  1. environment: card, power limit, torch; build every kernel from the
     three sources in the checkout (one nvcc per source, all started
     together, sm_90a) and print ptxas' report; the flash library's SASS
     must hold HGMMA (wgmma) instructions.
  2. each kernel against its plain version on the card, at the shapes
     the main paths give it and at edge cases, with stated tolerances;
     kernel / plain / library times and the card's bound at the
     MicroLlama-300M and hymba-1.5b prefill shapes (flash attention;
     hymba's with window 1024 and without), at the training
     stats shape (8, 304,636,928) (gradstats, with a bit-identical
     repeat) and at falcon-mamba-7b's and hymba-1.5b's prefill shapes
     (the selective scan, with a bit-identical repeat, at every lane
     count it has).  Each flash row names the path that ran: ``tc``
     (bf16, hd % 16 == 0: wgmma) or ``fma`` (f32 and other bf16 head
     dims).
  3. the main path: ``serve.generate`` on microllama-300m at full width
     in bf16 (seeded random weights), 4 prompts of 512 tokens, 32 greedy
     tokens; the flash kernel must launch once per layer, every launch on
     the tensor-core path.  Prefill and
     decode times are ``generate``'s own (CUDA events).  Then the same
     call sampling at temperature 1, twice: the tokens must repeat.
  4. the server: ``DenseBatcher`` and ``ContinuousBatcher`` at full
     width in f32 on one bursty trace; every request answered, no block
     leak, greedy tokens equal across both arms and ``generate``; every
     flash launch on the FMA path.
  4b. the SSM and hybrid main paths: ``serve.generate`` on
     falcon-mamba-7b at full width in bf16 (4 prompts of 512 tokens, 32
     greedy tokens; the scan kernel must launch 64 times per prefill,
     flash 0; kernel-vs-plain prefill logits within 5% of their largest
     magnitude) and on hymba-1.5b at full width in bf16 (2 prompts of
     1536 tokens, past the 1024-token window, 16 greedy tokens; flash
     (tensor-core path) and the scan 32 times each, and each kernel alone
     against the plain prefill); hymba-1.5b's prefill in f32, both
     kernels and each alone, within 1e-4 of the logits' largest
     magnitude, flash on the FMA path; then
     falcon-mamba-7b in f32 through both batchers on one bursty trace,
     as in phase 4.

  5. training: ``launch.train.run`` (the ``python -m
     repro_torch.launch.train`` entry point) on microllama-300m at full
     width in bf16 (seeded random weights), seq 128, k=2, M=2, H=2, T=3,
     batch 2 -> max 8, merge at t=3, per-sample stats on a probe of at
     most 8 through the gradstats kernels; then a two-round run with the
     microbatch estimator (B = M rows).  Per round: loss, requested
     batches, modes, pool size, comm events, wall time and the device
     time of each phase (``History.phase_ms``, CUDA events).  Fails
     unless the losses are finite, the requested batches never shrink,
     each gradstats kernel launched once per stats reduction, the flash
     kernel never launched, and the kernel and plain statistics of one
     stats round's G agree.

  6. the cluster runtime: ``repro_torch.cluster.run_cluster`` with the
     training phase's settings at full width in bf16, on simulated H100
     nodes (``cluster.node``'s defaults), each run with the gradstats
     counts set to 0 just before it and read just after, and held to
     one launch of each gradstats kernel per stats reduction (counted
     apart from the launch counts) and per round computed, and to
     kernel and plain statistics of its first stats round's G that
     agree.  ``sync`` (merging off, 4 nodes at a 2x speed spread, flat
     fabric) against ``train_adloco`` on the same inputs: losses,
     batches, the comm log and every round's f32 param checksum equal,
     final params bitwise equal;
     ``async`` (merging off, batch statistics piggybacked on the outer
     sync) on 2 pods x 2 nodes joined by 400 Gb/s InfiniBand under
     ``bursty_congestion`` timed from the reckoned round and sync
     (at least two windows inside the run), traced: every trainer runs
     T rounds, the Perfetto export validates, a second run gives the
     same trace digest and summary; ``elastic`` (merging on, 6 nodes, 2
     spare shards) with a slowdown, a leave and a join: the join clones
     a trainer onto the spare nodes and the final pool is what the
     events say.  Per run: simulated sim/compute/comm time, wall time,
     wall ms per round, peak memory, gradstats launches.

Then the ``kernels`` summary line (gradstats with the training and the
cluster path's launches), the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Without a card (or without the
repository around it) it exits non-zero and prints no result.

TF32 is switched off for matmuls and cuDNN, so every f32 product runs in
full f32 and f32 comparisons measure the kernels, not TF32 rounding.

Times of the flash and scan kernels, their plain versions and library
calls are device times (``device_ms``: CUDA events around one call,
queued behind a spin kernel so that the host's launch path falls
outside them); their rows also give ``*_call_ms``, back-to-back calls
timed by CUDA events, which the host's time per call sets once a kernel
is shorter than it.  Gradstats' times are CUDA-event
times (its kernels take milliseconds).
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.cluster.node import HBM_BW, PEAK_FLOPS as PEAK_BF16  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# FLOP/s by input type (bf16 on the tensor cores, as the cluster's node
# profiles take them; f32 on the CUDA cores)
PEAK_BYTES = HBM_BW
PEAK_FLOPS = {torch.bfloat16: PEAK_BF16, torch.float32: 67e12}
# special-function-unit results (exp2 and kin) per clock per SM on
# compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput): every expf issues one
SFU_PER_CLOCK_PER_SM = 16
# tests/test_kernels.py:_tol
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
SCAN_SRC = "src/repro_torch/csrc/mamba_scan.cu"
SCAN_TPU = "src/repro/kernels/mamba_scan/kernel.py:27"
FLASH_SRC = "src/repro_torch/csrc/flash_attention.cu"
FLASH_TPU = "src/repro/kernels/flash_attention/kernel.py:30"
GRADSTATS_SRC = "src/repro_torch/csrc/gradstats.cu"
COLSUM_TPU = "src/repro/kernels/gradstats/kernel.py:29"
MOMENTS_TPU = "src/repro/kernels/gradstats/kernel.py:40"
KERNEL_SOURCES = {"flash_attention": FLASH_SRC, "gradstats": GRADSTATS_SRC,
                  "mamba_scan": SCAN_SRC}
# microllama-300m's parameter count: the columns of the training stats G
D_MICROLLAMA = 304_636_928


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def timed(name: str, fn, *args):
    """Run one phase and print its wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    emit("phase_seconds", name=name, seconds=time.perf_counter() - t0)
    return out


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    from CUDA events, after ``warmup`` calls (inputs stay in L2)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


_sleep_cycles_per_ms = None


def sleep_cycles_per_ms() -> float:
    """Clock cycles per ms of ``torch.cuda._sleep``'s spin kernel,
    timed once by CUDA events."""
    global _sleep_cycles_per_ms
    if _sleep_cycles_per_ms is None:
        cycles = 1 << 24
        torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _sleep_cycles_per_ms = cycles / start.elapsed_time(end)
    return _sleep_cycles_per_ms


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: the median over ``iters``
    calls of the CUDA events recorded just before and just after one
    call.  Before each call a spin kernel holds the stream for twice
    the host's time per call plus 50 us, so the host has queued the
    events and the call's kernels before the card reaches them, and the
    interval holds the call's device work, not its launch path (which
    back-to-back ``cuda_ms`` includes once a kernel is shorter than
    it).  It needs no profiler."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int((2 * host_ms + 0.05) * sleep_cycles_per_ms())
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    ms = statistics.median(s.elapsed_time(e) for s, e in pairs)
    if not ms > 0:
        raise AssertionError(f"no device time measured: {ms}")
    return ms


def visible_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave visible: the work this call
    needs."""
    i = torch.arange(S, dtype=torch.int64)
    hi = i + 1 if causal else torch.full_like(i, S)
    lo = torch.clamp(i - window + 1, min=0)
    return int(torch.clamp(hi - lo, min=0).sum())


def flash_bound(q, k, v, causal: bool, window: int):
    """(bound_ms, bound_by, bytes, flops): each input read once, the
    output written once, against 4*hd FLOPs per visible pair and head."""
    B, S, H, hd = q.shape
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * B * H * hd * visible_pairs(S, causal, window)
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[q.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def phase_env():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(),
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        built = dict(zip(KERNEL_SOURCES,
                         pool.map(_build.build, KERNEL_SOURCES)))
    wall = time.perf_counter() - t0
    hgmma = None
    for name, b in built.items():
        ptxas = [line.strip() for line in b.log.splitlines()
                 if "registers" in line or "spill" in line]
        extra = {}
        if name == "flash_attention":
            hgmma = extra["hgmma_in_sass"] = sass_count(b.path, "HGMMA")
        emit("build", kernel=name, source=KERNEL_SOURCES[name],
             nvcc_seconds=b.seconds, all_builds_and_loads_seconds=wall,
             library=str(b.path.relative_to(ROOT)), ptxas=ptxas, **extra)
    if not hgmma:
        raise AssertionError("the flash library's SASS holds no HGMMA: the "
                             "bf16 path does not reach the tensor cores")
    return smi, hgmma


def sass_count(lib: Path, opcode: str) -> int:
    """Lines of ``cuobjdump -sass lib`` that hold ``opcode``."""
    from repro_torch.kernels._build import nvcc_path
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    return sum(opcode in line for line in sass.splitlines())


def phase_kernels():
    """Flash kernel against its plain version; times at the MicroLlama
    and hymba-1.5b prefill shapes.  Returns the timed rows, MicroLlama's
    B=4 first."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel, ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (B, S, H, Hk, hd, window, causal, dtype, timed)
        (4, 512, 16, 4, 64, None, True, bf16, True),   # MicroLlama B=4
        (4, 512, 16, 4, 64, None, True, f32, False),
        (1, 2048, 16, 4, 64, None, True, bf16, True),  # MicroLlama B=1
        (2, 1536, 25, 5, 64, 1024, True, bf16, True),  # hymba local layers
        (2, 1536, 25, 5, 64, None, True, bf16, True),  # hymba global layers
        (2, 200, 4, 2, 64, None, True, f32, False),    # ragged S
        (2, 256, 4, 1, 64, 100, True, f32, False),
        (1, 384, 6, 3, 128, 64, True, f32, False),
        (1, 96, 4, 4, 80, None, True, f32, False),
        (1, 128, 8, 8, 32, None, True, f32, False),    # hd <= 32
        (1, 192, 4, 2, 64, None, False, f32, False),   # padded bidirectional
        # bf16 on the tensor-core path: hd 128, 80 and 32, ragged S, a
        # window smaller than a tile, bidirectional at a padded S, every
        # row fully masked (window 0: the kernel writes 0); hd 40 on FMA
        (1, 384, 6, 3, 128, 64, True, bf16, False),
        (1, 96, 4, 4, 80, None, True, bf16, False),
        (1, 128, 8, 8, 32, None, True, bf16, False),
        (2, 200, 4, 2, 64, None, True, bf16, False),
        (2, 256, 4, 1, 64, 17, True, bf16, False),
        (1, 192, 4, 2, 64, None, False, bf16, False),
        (1, 130, 4, 2, 128, 0, True, bf16, False),
        (1, 96, 4, 2, 40, None, True, bf16, False),
    ]
    rows = []
    for B, S, H, Hk, hd, window, causal, dt, timed in cases:
        gen = torch.Generator(device="cuda").manual_seed(S + hd)
        q, k, v = (torch.randn((B, S, h, hd), generator=gen, device="cuda")
                   .to(dt) for h in (H, Hk, Hk))
        w = ops.normalize_window(window)
        before = ops.tc_launches, ops.fma_launches
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ran = {"tc": ops.tc_launches - before[0],
               "fma": ops.fma_launches - before[1]}
        path = kernel.choose_path(dt, hd)
        ref = flash_attention_ref(q, k, v, causal=causal, window=w)
        if w <= 0:   # no visible key: the kernel writes 0 by contract
            ref = torch.zeros_like(ref)
        err = (out.float() - ref.float()).abs().max().item()
        ok = torch.allclose(out.float(), ref.float(), rtol=TOL[dt],
                            atol=TOL[dt]) and ran[path] == 1 \
            and sum(ran.values()) == 1
        row = dict(shape=[B, S, H, Hk, hd], window=window, causal=causal,
                   dtype=str(dt).replace("torch.", ""), path=path,
                   launches_by_path=ran, max_abs_err=err, tol=TOL[dt], ok=ok)
        if timed:
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            # the library call computes the same function: a window
            # becomes a boolean mask of key i - d, 0 <= d < window
            mask = None
            if window is not None:
                i = torch.arange(S, device="cuda")
                d = i[:, None] - i[None, :]
                mask = (d < w) & (d >= 0) if causal else d < w

            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask,
                    is_causal=causal and mask is None, enable_gqa=True)

            def call():
                return ops.flash_attention(q, k, v, causal=causal,
                                           window=window)

            lib = library()
            bound_ms, bound_by, nbytes, flops = flash_bound(q, k, v, causal, w)
            # *_ms: device time per call; *_call_ms: back-to-back calls
            # timed by CUDA events, which host time per call can set
            row.update(
                kernel_ms=device_ms(call), kernel_call_ms=cuda_ms(call),
                plain_ms=device_ms(lambda: flash_attention_ref(
                    q, k, v, causal=causal, window=w), iters=10),
                library_ms=device_ms(library),
                library_call_ms=cuda_ms(library),
                library_max_abs_err=(lib.transpose(1, 2).float()
                                     - out.float()).abs().max().item(),
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                flops=flops)
            rows.append(row)
        emit("kernel_check", kernel="flash_attention", **row)
        if not ok:
            raise AssertionError(f"flash kernel disagrees with its plain "
                                 f"version: {row}")
    return rows


def gradstats_bounds(B: int, D: int, elem: int):
    """(bound_ms, bound_by) per kernel: each input read once, each
    output written once, against the f32 operations per element (an add
    in colsum; two multiply-adds in moments, plus n2's)."""
    out = {}
    for name, nbytes, flops in (
            ("colsum", B * D * elem + D * 4, B * D),
            ("moments", B * D * elem + D * 4 + (2 * B + 1) * 4,
             4 * B * D + 2 * D)):
        t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[torch.float32]
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def phase_gradstats_kernels():
    """Both gradstats kernels against their plain versions, with a
    bit-identical repeat; times at the training main path's shape
    (8, 304,636,928) f32.  Returns the per-kernel summary there."""
    from repro_torch.kernels.gradstats import kernel, ops
    from repro_torch.kernels.gradstats.ref import (colsum_mean_ref,
                                                   gradstats_reduce_ref,
                                                   moments_ref)

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (B, D, dtype, timed)
        (8, D_MICROLLAMA, f32, True),    # per-sample probe of 8
        (2, D_MICROLLAMA, f32, False),   # microbatch estimator, M = 2
        (1, 16, f32, False), (5, 193, f32, False), (13, 1027, f32, False),
        (31, 1000, bf16, False), (64, 4096, f32, False),
    ]
    summary = None
    for B, D, dt, timed in cases:
        gen = torch.Generator(device="cuda").manual_seed(B * 7 + D % 1000)
        G = torch.randn((B, D), generator=gen, device="cuda")
        G = G.mul_(2.0).add_(0.3).to(dt)
        got = ops.gradstats_reduce(G)
        again = ops.gradstats_reduce(G)
        torch.cuda.synchronize()
        repeat_identical = all(torch.equal(a, b) for a, b in zip(got, again))
        want = gradstats_reduce_ref(G)
        errs, ok = {}, repeat_identical
        for name, g, w in zip(("s", "d", "n2"), got, want):
            errs[name] = (g - w).abs().max().item()
            errs[name + "_rel"] = errs[name] / w.abs().max().item()
            ok = ok and torch.allclose(g, w, rtol=TOL[dt], atol=TOL[dt])
        gbar = kernel.colsum_mean(G)
        gbar_ref = colsum_mean_ref(G)
        errs["gbar"] = (gbar - gbar_ref).abs().max().item()
        ok = ok and torch.allclose(gbar, gbar_ref, rtol=TOL[dt], atol=TOL[dt])
        row = dict(shape=[B, D], dtype=str(dt).replace("torch.", ""),
                   repeat_bit_identical=repeat_identical, tol=TOL[dt],
                   ok=ok, **errs)
        if timed:
            bounds = gradstats_bounds(B, D, G.element_size())
            row.update(
                pair_ms=cuda_ms(lambda: ops.gradstats_reduce(G), iters=10,
                                warmup=2),
                colsum_ms=cuda_ms(lambda: kernel.colsum_mean(G), iters=10,
                                  warmup=2),
                moments_ms=cuda_ms(lambda: kernel.moments(G, gbar),
                                   iters=10, warmup=2),
                plain_pair_ms=cuda_ms(lambda: gradstats_reduce_ref(G),
                                      iters=5, warmup=1),
                plain_colsum_ms=cuda_ms(lambda: colsum_mean_ref(G), iters=5,
                                        warmup=1),
                plain_moments_ms=cuda_ms(lambda: moments_ref(G, gbar_ref),
                                         iters=5, warmup=1),
                # one PyTorch call per function: the column mean, and the
                # Gram matrix G G^T from which s, d and n2 all follow
                library_colsum_ms=cuda_ms(
                    lambda: torch.mean(G, dim=0, dtype=f32), iters=5,
                    warmup=1),
                library_gram_ms=cuda_ms(lambda: torch.mm(G, G.T), iters=5,
                                        warmup=1),
                pair_bound_ms=B * D * G.element_size() / PEAK_BYTES * 1e3,
                colsum_bound_ms=bounds["colsum"][0],
                colsum_bound_by=bounds["colsum"][1],
                moments_bound_ms=bounds["moments"][0],
                moments_bound_by=bounds["moments"][1])
            summary = row
        emit("kernel_check", kernel="gradstats", **row)
        del G, got, again, want, gbar, gbar_ref
        if not ok:
            raise AssertionError(f"gradstats kernels disagree with their "
                                 f"plain versions: {row}")
    return summary


def sm_clock_hz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reads it."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.split()[0]
    return float(mhz) * 1e6


def scan_bound(B: int, S: int, di: int, n: int, elem: int, sms: int,
               clock_hz: float):
    """(bound_ms, bound_by, bytes, flops, exps, t_bytes, t_flops, t_exps):
    u, dt, Bm, Cm and the f32 neg_A read once, y and h_last written
    once, against the larger of 6 f32 operations per (b, t, d, k) at the
    f32 rate (the kernel computes in f32 whatever its input type) and
    one exp per (b, t, d, k) on the special-function units,
    ``SFU_PER_CLOCK_PER_SM`` per clock on each SM."""
    nbytes = (3 * B * S * di + 2 * B * S * n) * elem + 4 * di * n \
        + B * di * n * elem
    flops = 6 * B * S * di * n
    exps = B * S * di * n
    t_bytes = nbytes / PEAK_BYTES
    t_flops = flops / PEAK_FLOPS[torch.float32]
    t_exps = exps / (sms * SFU_PER_CLOCK_PER_SM * clock_hz)
    t_ops = max(t_flops, t_exps)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops,
            exps, t_bytes * 1e3, t_flops * 1e3, t_exps * 1e3)


def scan_inputs(B, S, di, n, dt_, seed):
    """Scan inputs on the card with tests/test_kernels.py's
    distributions; Bm and Cm are views split off one (B, S, r + 2n)
    tensor, as ``layers.mamba_forward`` passes them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn((B, S, di), generator=gen, device="cuda").to(dt_)
    dt = (torch.nn.functional.softplus(
        torch.randn((B, S, di), generator=gen, device="cuda")) * 0.1
    ).to(dt_)
    A_log = torch.log(torch.randn((di, n), generator=gen,
                                  device="cuda").abs() + 0.5)
    r = 8
    BC = torch.randn((B, S, r + 2 * n), generator=gen, device="cuda").to(dt_)
    return u, dt, A_log, BC[..., r:r + n], BC[..., r + n:]


def scan_grid(B: int, di: int, lanes: int, sms: int) -> dict:
    """The scan kernel's grid: blocks of 256 threads, 256 / lanes
    channels each."""
    blocks = -(-di // (256 // lanes)) * B
    return dict(grid_blocks=blocks, warps_per_sm=blocks * 8 / sms)


def phase_scan_kernels():
    """The selective-scan kernel against its plain version (the chunked
    associative scan), with a bit-identical repeat; times at the
    falcon-mamba-7b and hymba-1.5b prefill shapes.  Returns the timed
    rows, falcon-mamba-7b's first."""
    from repro_torch.kernels.mamba_scan import kernel, ops
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
    from repro_torch.models.layers import ssm_scan_seq

    bf16, f32 = torch.bfloat16, torch.float32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = sm_clock_hz()
    cases = [  # (B, S, di, n, dtype, timed)
        (4, 512, 8192, 16, bf16, True),     # falcon-mamba-7b prefill
        (2, 1536, 3200, 16, bf16, True),    # hymba-1.5b prefill
        (2, 256, 128, 16, f32, False),      # tests/test_kernels.py cases
        (1, 200, 96, 8, f32, False),        # ragged S and di
        (2, 64, 256, 16, f32, False),
        (1, 128, 128, 16, bf16, False),
        (1, 1, 96, 8, f32, False),          # S = 1
        (4, 512, 8192, 16, f32, False),
        # one case for each lane count the dispatch picks (kernel.py's
        # choose_lanes): falcon's and hymba's shapes take 4, (1, 128,
        # 128, 16) above 16
        (2, 256, 1024, 16, bf16, False),    # 8 lanes
        (1, 64, 32768, 8, f32, False),      # n <= 8: 4 lanes
        (1, 200, 96, 8, bf16, False),       # n <= 8: 8 lanes
    ]
    rows = []
    for B, S, di, n, dt_, timed_case in cases:
        x = scan_inputs(B, S, di, n, dt_, seed=S + di + n)
        y, h = ops.mamba_scan(*x)
        y2, h2 = ops.mamba_scan(*x)
        torch.cuda.synchronize()
        repeat = torch.equal(y, y2) and torch.equal(h, h2)
        yr, hr = mamba_scan_ref(*x)
        err_y = (y.float() - yr.float()).abs().max().item()
        err_h = (h.float() - hr.float()).abs().max().item()
        ok = repeat and all(torch.allclose(a.float(), b.float(),
                                           rtol=TOL[dt_], atol=TOL[dt_])
                            for a, b in ((y, yr), (h, hr)))
        lanes = kernel.choose_lanes(B, di, n)
        row = dict(shape=[B, S, di, n], dtype=str(dt_).replace("torch.", ""),
                   max_abs_err=max(err_y, err_h), y_max_abs_err=err_y,
                   h_max_abs_err=err_h, repeat_bit_identical=repeat,
                   tol=TOL[dt_], ok=ok, lanes=lanes, sms=sms,
                   **scan_grid(B, di, lanes, sms))
        if timed_case:
            # every lane count the kernel has, held to the same
            # tolerance and timed (direct binding calls: not counted)
            neg_A = -torch.exp(x[2].float())
            by_lanes = {}
            for lanes_ in kernel.LANES:
                yl, hl = kernel.mamba_scan_fwd(x[0], x[1], neg_A, x[3], x[4],
                                               lanes=lanes_)
                torch.cuda.synchronize()
                err_l = max((yl.float() - yr.float()).abs().max().item(),
                            (hl.float() - hr.float()).abs().max().item())
                ok = ok and all(torch.allclose(a.float(), b.float(),
                                               rtol=TOL[dt_], atol=TOL[dt_])
                                for a, b in ((yl, yr), (hl, hr)))
                by_lanes[lanes_] = dict(
                    max_abs_err=err_l, kernel_ms=device_ms(
                        lambda: kernel.mamba_scan_fwd(
                            x[0], x[1], neg_A, x[3], x[4], lanes=lanes_)),
                    **scan_grid(B, di, lanes_, sms))
                del yl, hl
            row.update(by_lanes=by_lanes, ok=ok)
            u_elem = x[0].element_size()
            (bound_ms, bound_by, nbytes, flops, exps, bytes_ms, flops_ms,
             exps_ms) = scan_bound(B, S, di, n, u_elem, sms, clock_hz)
            kernel_ms = device_ms(lambda: ops.mamba_scan(*x))
            row.update(
                kernel_ms=kernel_ms,
                kernel_call_ms=cuda_ms(lambda: ops.mamba_scan(*x), iters=20),
                plain_ms=device_ms(lambda: mamba_scan_ref(*x), iters=3,
                                   warmup=1),
                plain_seq_ms=device_ms(lambda: ssm_scan_seq(*x), iters=2,
                                       warmup=1),
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, flops=flops, exps=exps, elem_bytes=u_elem,
                bytes_bound_ms=bytes_ms, flops_bound_ms=flops_ms,
                exps_bound_ms=exps_ms, sm_clock_hz=clock_hz,
                achieved_bytes_per_s=nbytes / (kernel_ms * 1e-3),
                share_of_bound=bound_ms / kernel_ms)
            rows.append(row)
        emit("kernel_check", kernel="mamba_scan", **row)
        del x, y, h, y2, h2, yr, hr
        if not ok:
            raise AssertionError(f"scan kernel disagrees with its plain "
                                 f"version: {row}")
    torch.cuda.empty_cache()
    return rows


def launch_counts():
    """The launch counter of every kernel wrapper."""
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.gradstats import ops as gs
    from repro_torch.kernels.mamba_scan import ops as scan
    return {"flash_attention": flash.launches,
            "flash_attention_tc": flash.tc_launches,
            "flash_attention_fma": flash.fma_launches,
            "mamba_scan": scan.scan_launches,
            "gradstats_colsum": gs.colsum_launches,
            "gradstats_moments": gs.moments_launches}


def reset_counts():
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.gradstats import ops as gs
    from repro_torch.kernels.mamba_scan import ops as scan
    flash.launches = flash.tc_launches = flash.fma_launches = 0
    scan.scan_launches = 0
    gs.colsum_launches = gs.moments_launches = 0


@contextmanager
def only_kernel(name: str):
    """While active, ``prefill(use_kernels=True)`` runs the kernel
    ``name`` alone: every other wrapper is swapped for the plain
    function that the plain prefill calls in its place."""
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.mamba_scan import ops as scan
    from repro_torch.models import layers as L

    saved = flash.flash_attention, scan.mamba_scan
    if name != "flash_attention":
        flash.flash_attention = L.sdpa
    if name != "mamba_scan":
        scan.mamba_scan = L.ssm_scan_seq
    try:
        yield
    finally:
        flash.flash_attention, scan.mamba_scan = saved


def prefill_parity(params, cfg, prompts, cache_len: int, kernels,
                   rel_tol: float):
    """Last-position logits of the kernel prefill against the plain
    prefill's, held within ``rel_tol`` of the plain logits' largest
    magnitude.  Where the path runs several ``kernels``, each also runs
    alone, so a gap is traced to one kernel.  Returns (row, faults)."""
    from repro_torch import models

    def last(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = models.prefill(params, prompts, cfg, cache_len,
                                   last_only=True, **kw)
        torch.cuda.synchronize()
        return logits[:, -1].float(), time.perf_counter() - t0

    lk, kernel_s = last(use_kernels=True)
    lp, plain_s = last(use_kernels=False)
    scale = lp.abs().max().item()
    tol = rel_tol * scale
    row = dict(kernel_prefill_wall_s=kernel_s, plain_prefill_wall_s=plain_s,
               logits_finite=bool(torch.isfinite(lk).all()),
               last_logits_max_abs_err=(lk - lp).abs().max().item(),
               last_logits_scale=scale, rel_tol=rel_tol, tol=tol,
               greedy_next_token_agrees=int(
                   (lk.argmax(-1) == lp.argmax(-1)).sum()))
    errs = {"all": row["last_logits_max_abs_err"]}
    if len(kernels) > 1:
        alone = {}
        for name in kernels:
            with only_kernel(name):
                la, _ = last(use_kernels=True)
            alone[name] = (la - lp).abs().max().item()
        row["one_kernel_max_abs_err"] = alone
        errs.update(alone)
    faults = [] if row["logits_finite"] else ["non-finite logits from the "
                                              "kernel prefill"]
    faults += [f"kernel prefill ({k}) logits differ from the plain prefill "
               f"by {e} > {tol}" for k, e in errs.items() if e > tol]
    return row, faults


def check_ids(res, cfg, B: int, new: int):
    toks = torch.tensor(res.tokens)
    if toks.shape != (B, new) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name}: bad generated ids, shape "
                             f"{tuple(toks.shape)}")


def gen_times(res, wall_s: float, B: int, S: int, new: int):
    return dict(wall_s=wall_s, prefill_ms=res.prefill_ms,
                decode_ms=res.decode_ms,
                decode_ms_per_step=res.decode_ms / (new - 1),
                prefill_tok_per_s=B * S / res.prefill_ms * 1e3,
                decode_tok_per_s=B * (new - 1) / res.decode_ms * 1e3)


@torch.inference_mode()
def generate_main_path(arch: str, B: int, S: int, new: int, expect: dict):
    """``serve.generate`` on ``arch`` at full width in bf16 (seeded
    random weights), with every launch count set to 0 just before the
    call and read just after; each must equal ``expect``.  Then the
    kernel prefill's last logits against the plain prefill's, within 5%
    of their largest magnitude.  Returns the launch counts and (cfg,
    params, prompts, result)."""
    from repro_torch import models, serve
    from repro_torch.configs import get_config

    cfg = get_config(arch)                                   # bf16
    t0 = time.perf_counter()
    params = models.init_params(cfg, 0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device="cuda")
    serve.generate(params, cfg, prompts, max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = serve.generate(params, cfg, prompts, max_new_tokens=new)
    wall_s = time.perf_counter() - t0        # ends in a device->host copy
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_ids(res, cfg, B, new)

    # bf16: the plain path rounds the softmax probabilities to bf16
    # before the PV product and forms a block of scan steps at once, the
    # kernels keep f32 and sum in another order; the layers' bf16
    # residuals carry that to the logits
    row, faults = prefill_parity(params, cfg, prompts, S + new,
                                 [k for k in ("flash_attention", "mamba_scan")
                                  if expect[k]], 5e-2)
    emit("generate", arch=cfg.name, dtype=cfg.dtype, layers=cfg.num_layers,
         d_model=cfg.d_model, params=cfg.param_count(), batch=B, prompt=S,
         new_tokens=new, setup_s=setup_s, launches=launches,
         expected_launches=expect, **gen_times(res, wall_s, B, S, new),
         max_memory_allocated=peak, **row,
         first_tokens=[r[:8] for r in res.tokens])
    if {k: launches[k] for k in expect} != expect:
        raise AssertionError(f"{arch}: generate launched {launches}, "
                             f"expected {expect}")
    if faults:
        raise AssertionError(f"{arch}: {faults}")
    return launches, (cfg, params, prompts, res)


def phase_generate():
    """The main path on microllama-300m; then the same call sampling at
    temperature 1, twice: the tokens must repeat."""
    from repro_torch import serve

    B, S, new = 4, 512, 32
    launches, (cfg, params, prompts, res) = generate_main_path(
        "microllama-300m", B, S, new, {"flash_attention": 12,
                                       "flash_attention_tc": 12,
                                       "flash_attention_fma": 0,
                                       "mamba_scan": 0})
    # temperature sampling: noise drawn on the card from per-(seed, row,
    # step) generators, so the same call gives the same tokens
    runs = []
    with torch.inference_mode():
        for _ in range(2):
            reset_counts()
            t0 = time.perf_counter()
            r = serve.generate(params, cfg, prompts, max_new_tokens=new,
                               temperature=1.0, seed=0)
            counts = launch_counts()
            runs.append((r, time.perf_counter() - t0,
                         counts["flash_attention_tc"]))
            check_ids(r, cfg, B, new)
    same = runs[0][0].tokens == runs[1][0].tokens
    emit("generate_sampled", temperature=1.0, seed=0, reproducible=same,
         flash_launches=[n for _, _, n in runs],
         runs=[gen_times(r, w, B, S, new) for r, w, _ in runs],
         positions_equal_to_greedy=sum(
             x == y for a, g in zip(runs[0][0].tokens, res.tokens)
             for x, y in zip(a, g)),
         first_tokens=[row[:8] for row in runs[0][0].tokens])
    if not same:
        raise AssertionError("sampled generate is not reproducible from "
                             "its seed")
    if any(n != cfg.num_layers for _, _, n in runs):
        raise AssertionError("sampled generate's prefill did not launch the "
                             "tensor-core flash kernel once per layer")
    return launches


def phase_generate_ssm():
    return generate_main_path("falcon-mamba-7b", 4, 512, 32,
                              {"mamba_scan": 64, "flash_attention": 0,
                               "flash_attention_tc": 0,
                               "flash_attention_fma": 0})[0]


def phase_generate_hybrid():
    return generate_main_path("hymba-1.5b", 2, 1536, 16,
                              {"mamba_scan": 32, "flash_attention": 32,
                               "flash_attention_tc": 32,
                               "flash_attention_fma": 0})[0]


@torch.inference_mode()
def phase_hybrid_f32():
    """hymba-1.5b at full width in f32, at the hybrid main path's prompt
    shape: kernel prefill against plain prefill, both kernels and each
    alone, within 1e-4 of the logits' largest magnitude.  In f32 the
    two differ only in summation order, so a wrong window mask or head
    mapping would show far above it."""
    from repro_torch import models
    from repro_torch.configs import get_config

    cfg = get_config("hymba-1.5b").with_overrides(dtype="float32")
    B, S = 2, 1536
    params = models.init_params(cfg, 0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device="cuda")
    reset_counts()
    row, faults = prefill_parity(params, cfg, prompts, S,
                                 ["flash_attention", "mamba_scan"], 1e-4)
    launches = launch_counts()
    emit("prefill_f32", arch=cfg.name, batch=B, prompt=S, launches=launches,
         **row)
    if launches["flash_attention_tc"] or not launches["flash_attention_fma"]:
        faults.append(f"f32 flash must run the FMA path only: {launches}")
    if faults:
        raise AssertionError(f"{cfg.name} f32: {faults}")


def _first_divergence(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


@torch.inference_mode()
def phase_server(arch: str = "microllama-300m",
                 kernel: str = "flash_attention"):
    """Both batchers on ``arch`` at full width in f32, one bursty trace;
    the dense arm's prefill must launch ``kernel``."""
    from repro_torch import models, serve
    from repro_torch.configs import get_config
    from repro_torch.serve import traffic
    from repro_torch.serve.scheduler import ContinuousBatcher, DenseBatcher

    cfg = get_config(arch).with_overrides(dtype="float32")
    params = models.init_params(cfg, 0)
    spec = traffic.make_arrivals("bursty", n_requests=8, prompt_lo=64,
                                 prompt_hi=512, new_lo=8, new_hi=32)
    cache_len = 512 + 32
    arms = {
        "dense": DenseBatcher(params, cfg, n_slots=4, cache_len=cache_len),
        "paged": ContinuousBatcher(params, cfg, n_slots=4,
                                   cache_len=cache_len, block_size=16,
                                   chunk_size=128),
    }
    outs, launches = {}, {}
    for name, batcher in arms.items():
        arrivals = traffic.materialize(spec, cfg.vocab_size)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = batcher.run_trace(arrivals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = launch_counts()
        outs[name] = {r.rid: r.generated for _, r in arrivals}
        emit("server", arch=cfg.name, arm=name, dtype=cfg.dtype, wall_s=wall,
             launches=launches[name], report=rep.__dict__)
        if rep.requests_finished != len(spec) or rep.requests_pending:
            raise AssertionError(f"{name}: not every request was answered")
    if not arms["paged"].pool.no_leak():
        raise AssertionError("paged arm leaked KV blocks")
    if launches["dense"][kernel] <= 0:
        raise AssertionError("the dense arm's prefill never ran the kernel")
    if launches["dense"]["flash_attention_tc"] or (
            launches["dense"]["flash_attention_fma"]
            != launches["dense"]["flash_attention"]):
        raise AssertionError(f"f32 flash must run the FMA path only: "
                             f"{launches['dense']}")

    prompts = {a.rid: r.tokens for a, (_, r) in
               zip(spec, traffic.materialize(spec, cfg.vocab_size))}
    excused = []
    for a in spec:
        want = serve.generate(params, cfg, [prompts[a.rid]],
                              max_new_tokens=a.max_new_tokens).tokens[0]
        for arm in ("dense", "paged"):
            got = outs[arm][a.rid]
            i = _first_divergence(got, want)
            if i is None:
                continue
            # a near-tie may flip under f32 summation order: measure the
            # top-2 gap of the logits at the first divergent position
            seq = torch.tensor([prompts[a.rid] + want[:i]], device="cuda")
            logits, _ = models.prefill(params, seq, cfg, seq.shape[1],
                                       use_kernels=True, last_only=True)
            top2 = torch.topk(logits[0, -1].float(), 2).values
            gap = (top2[0] - top2[1]).item()
            row = dict(rid=a.rid, arm=arm, position=i, top2_gap=gap)
            if gap >= 1e-3:
                raise AssertionError(f"greedy tokens diverge away from a "
                                     f"near-tie: {row}")
            excused.append(row)
    emit("server_parity", arch=cfg.name, requests=len(spec),
         excused_near_ties=excused, matches_generate=len(excused) == 0)
    if arch != "microllama-300m":
        return launches

    # f32: kernel prefill against plain prefill at full width, one request
    seq = torch.tensor([prompts[spec[0].rid]], device="cuda")
    lk, _ = models.prefill(params, seq, cfg, seq.shape[1], use_kernels=True,
                           last_only=True)
    lp, _ = models.prefill(params, seq, cfg, seq.shape[1], use_kernels=False,
                           last_only=True)
    err = (lk - lp).abs().max().item()
    # f32 sums in another order through 12 layers; logits are O(5)
    emit("prefill_f32", prompt=seq.shape[1], last_logits_max_abs_err=err,
         tol=1e-4)
    if err > 1e-4:
        raise AssertionError(f"f32 kernel prefill differs from the plain "
                             f"prefill by {err}")
    return launches


@contextmanager
def compare_one_stats_round(rec: dict):
    """While active, the first kernel-route stats reduction of the run
    is also computed through the plain version on the same G (no kernel
    launch), and every reduction is counted."""
    from repro_torch.core import batching

    orig = batching.stats_from_matrix

    def hooked(G, *, use_kernel=False):
        st = orig(G, use_kernel=use_kernel)
        rec["reductions"] += 1
        if use_kernel and "kernel" not in rec:
            rec["shape"] = list(G.shape)
            rec["kernel"] = [float(v) for v in st]
            rec["plain"] = [float(v) for v in orig(G, use_kernel=False)]
        return st

    batching.stats_from_matrix = hooked
    try:
        yield rec
    finally:
        batching.stats_from_matrix = orig


def stats_agree(rec: dict) -> bool:
    """Whether the kernel and plain stats of ``compare_one_stats_round``
    agree: tests/test_kernels.py's drop-in criterion, at 1e-4 relative."""
    scale = max(abs(v) for v in rec["plain"]) + 1e-6
    return all(abs(x - y) <= 1e-4 * max(abs(x), abs(y)) + 1e-4 * scale
               for x, y in zip(rec["kernel"], rec["plain"]))


def run_training(label: str, argv):
    """One ``launch.train.run`` on the card with the launch counts set
    to 0 just before it and read just after; checks the run."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.gradstats import ops as gs_ops
    from repro_torch.launch import train

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = {"reductions": 0}
    flash_ops.launches = 0
    gs_ops.colsum_launches = gs_ops.moments_launches = 0
    t0 = time.perf_counter()
    with compare_one_stats_round(rec):
        pool, hist, cfg = train.run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"colsum": gs_ops.colsum_launches,
                "moments": gs_ops.moments_launches,
                "flash_attention": flash_ops.launches}
    peak = torch.cuda.max_memory_allocated()
    for i, t in enumerate(hist.outer_step):
        emit("train_round", run=label, round=t, loss=hist.loss[i],
             requested_batches=hist.requested_batches[i],
             modes=hist.modes[i], pool_size=hist.pool_size[i],
             comm_events=hist.comm_events[i], wall_s=hist.wall[i],
             device_ms=hist.phase_ms[i])
    final = pool.global_params
    finite = all(bool(torch.isfinite(v.float()).all())
                 for v in final.values())
    names = ("mean_norm2", "sigma2", "ip_var", "orth_var", "b")
    agree = stats_agree(rec)
    expected = sum(hist.pool_size)          # one reduction per trainer round
    emit("train", run=label, arch=cfg.name, dtype=cfg.dtype,
         params=cfg.param_count(), argv=argv,
         wall_s=wall, max_memory_allocated=peak, launches=launches,
         stats_reductions=rec["reductions"], expected_reductions=expected,
         stats_G_shape=rec["shape"],
         stats_kernel=dict(zip(names, rec["kernel"])),
         stats_plain=dict(zip(names, rec["plain"])), stats_agree=agree,
         final_params_finite=finite, comm_events=pool.comms.events)
    if not all(math.isfinite(x) for x in hist.loss) or not finite:
        raise AssertionError(f"{label}: non-finite loss or parameters")
    for prev, cur, k0, k1 in zip(hist.requested_batches,
                                 hist.requested_batches[1:],
                                 hist.pool_size, hist.pool_size[1:]):
        if max(cur) < max(prev) or (k0 == k1 and any(
                c < p for p, c in zip(prev, cur))):
            raise AssertionError(f"{label}: requested batches shrank: "
                                 f"{hist.requested_batches}")
    if not (rec["reductions"] == expected
            == launches["colsum"] == launches["moments"]):
        raise AssertionError(f"{label}: gradstats launches {launches} "
                             f"against {rec['reductions']} stats "
                             f"reductions ({expected} expected)")
    if launches["flash_attention"] != 0:
        raise AssertionError(f"{label}: training launched the flash kernel")
    if not agree:
        raise AssertionError(f"{label}: kernel and plain stats differ: "
                             f"{rec}")
    return launches


TRAIN_ARGV = ["--arch", "microllama-300m", "--seq-len", "128",
              "--trainers", "2", "--workers", "2", "--inner-steps", "2",
              "--outer-steps", "3", "--initial-batch", "2", "--max-batch",
              "8", "--merge-frequency", "3", "--stats-probe-size", "8"]


def phase_train():
    """Algorithm 3 at full width in bf16; then the microbatch estimator.
    Returns the gradstats launches of the per-sample run."""
    launches = run_training("per_sample", TRAIN_ARGV)
    run_training("microbatch", TRAIN_ARGV + [
        "--outer-steps", "2", "--stats-estimator", "microbatch"])
    return launches


# the links between pods in the async cluster run: one 400 Gb/s NDR
# InfiniBand NIC per node (NVIDIA ConnectX-7), in bytes/s, and a few us
# per hop through its switch (a choice of this script)
IB_NDR_BW = 400e9 / 8
IB_NDR_LATENCY = 5e-6


def cluster_inputs(spares: int):
    """Model, loss, config and fresh seeded inputs on the card of
    ``launch.train``'s settings (``TRAIN_ARGV``), with ``spares`` spare
    data shards."""
    from repro_torch import models
    from repro_torch.data import make_shard_streams
    from repro_torch.launch import train
    from repro_torch.models import lm

    args = train.parse_args(TRAIN_ARGV)
    cfg, acfg = train.make_configs(args)
    k, M = acfg.num_init_trainers, acfg.nodes_per_gpu
    inits = [lm.param_dict(models.init_params(
        cfg, train.trainer_seed(acfg.seed, i), device="cuda"))
        for i in range(k)]
    streams = make_shard_streams(cfg.vocab_size, args.seq_len, k * M + spares,
                                 seed=acfg.seed, device="cuda")
    return cfg, acfg, train.build_loss_fn(cfg), inits, streams


def param_checksum(params) -> float:
    """f32 sum of every parameter (the cluster runs' ``eval_fn``: a
    deterministic reduction, so equal params give equal sums)."""
    return float(torch.stack([v.float().sum() for v in params.values()])
                 .sum())


def cluster_run(label: str, *, spares: int = 0, acfg_kw=None, **kw):
    """One ``run_cluster`` on the card with the gradstats counts set to 0
    just before it and read just after, its stats reductions counted and
    the first one also computed by the plain version; prints the run's
    line and checks the run."""
    from repro_torch.cluster import run_cluster
    from repro_torch.kernels.gradstats import ops as gs_ops

    cfg, acfg, loss_fn, inits, streams = cluster_inputs(spares)
    acfg = dataclasses.replace(acfg, **(acfg_kw or {}))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = {"reductions": 0}
    gs_ops.colsum_launches = gs_ops.moments_launches = 0
    t0 = time.perf_counter()
    with compare_one_stats_round(rec):
        pool, hist, rep = run_cluster(loss_fn, inits, streams, acfg,
                                      eval_fn=param_checksum, device="cuda",
                                      **kw)
    wall = time.perf_counter() - t0
    launches = {"colsum": gs_ops.colsum_launches,
                "moments": gs_ops.moments_launches}
    peak = torch.cuda.max_memory_allocated()
    agree = stats_agree(rec)
    s = rep.summary(extended=True)
    emit("cluster", run=label, policy=rep.policy, scenario=rep.scenario,
         sim_time=rep.sim_time, compute_time=rep.compute_time,
         comm_time=rep.comm_time, num_syncs=rep.num_syncs,
         num_stats_syncs=rep.num_stats_syncs, rounds=rep.rounds,
         pool_size=pool.k, wall_s=wall,
         round_wall_ms=[w * 1e3 for w in rep.round_wall_s],
         mean_round_wall_ms=1e3 * statistics.fmean(rep.round_wall_s),
         max_memory_allocated=peak, gradstats_launches=launches,
         rounds_computed=len(rep.round_wall_s),
         stats_reductions=rec["reductions"], stats_G_shape=rec["shape"],
         stats_kernel=rec["kernel"], stats_plain=rec["plain"],
         stats_agree=agree,
         losses=hist.loss, requested_batches=hist.requested_batches,
         overlap_frac=s.get("overlap_frac"),
         utilization=s.get("utilization"),
         applied_events=[{k: v for k, v in e.items()}
                         for e in rep.applied_events])
    # every stats reduction launches both kernels once, and every round
    # computed (preempted ones too) reduces its statistics once.  Async
    # fuses only the newest of them onto an outer sync, so
    # num_stats_syncs may count fewer.
    rounds = len(rep.round_wall_s)
    if not (rec["reductions"] == launches["colsum"] == launches["moments"]
            == rounds > 0):
        raise AssertionError(f"{label}: gradstats launches {launches} "
                             f"against {rec['reductions']} stats reductions "
                             f"and {rounds} rounds computed")
    if not agree:
        raise AssertionError(f"{label}: kernel and plain stats differ: "
                             f"{rec}")
    if not all(math.isfinite(x) for x in hist.loss):
        raise AssertionError(f"{label}: non-finite loss {hist.loss}")
    return pool, hist, rep, launches


def round_estimates(cfg, profiles, batch: int, H: int, stats: bool,
                    network, nodes):
    """(round s, outer sync s) on the simulated clock for one trainer on
    ``nodes``: the node roofline of H inner steps at ``batch`` samples
    (6·N·samples FLOPs, 3 param passes per step), and the outer
    all-reduce of the params (plus the stats vector when ``stats``)."""
    n = cfg.param_count()
    pbytes = 2 * n                                 # bf16 params
    compute = max(p.compute_time(6.0 * n * batch * H, 3.0 * pbytes * H, 0.0)
                  for p in nodes)
    payload = pbytes + (4.0 * (n + 6) if stats else 0.0)
    return compute, network.allreduce_time(payload, nodes, now=0.0)


def phase_cluster():
    """The cluster runtime at full width: sync (against ``train_adloco``
    on the same inputs), async on a 2-pod fabric under bursty
    congestion (traced, twice: the digest repeats), elastic with a
    slowdown, a leave and a join.  Returns the gradstats launches of the
    three cluster runs, by run."""
    from repro_torch.cluster import (ClusterEvent, NetworkModel, Topology,
                                     Trace, build_scenario, interleave_pods,
                                     make_heterogeneous_profiles,
                                     make_pod_profiles, validate_perfetto)
    from repro_torch.core import train_adloco

    launches = {}

    # 1. sync, merging off: the numerics of train_adloco
    profiles = make_heterogeneous_profiles(4, ratio=2.0)
    pool, hist, rep, launches["sync"] = cluster_run(
        "sync", acfg_kw={"enable_merge": False}, policy="sync",
        profiles=profiles, network=NetworkModel())
    cfg, acfg, loss_fn, inits, streams = cluster_inputs(0)
    acfg = dataclasses.replace(acfg, enable_merge=False)
    pool_l, hist_l = train_adloco(loss_fn, inits, streams, acfg,
                                  eval_fn=param_checksum, device="cuda")
    k = acfg.num_init_trainers
    per = {}                          # (round, tid) -> (loss, batch, sum)
    for t, ev, loss, bs in zip(hist.outer_step, hist.eval_loss_by_trainer,
                               hist.loss, hist.requested_batches):
        (tid, chk), = ev.items()
        per[t, tid] = (loss, bs[tid], chk)
    losses_c = [sum([per[t, i][0] for i in range(k)]) / k
                for t in hist_l.outer_step]
    batches_c = [[per[t, i][1] for i in range(k)] for t in hist_l.outer_step]
    sums_equal = all(per[t, i][2] == hist_l.eval_loss_by_trainer[t - 1][i]
                     for t in hist_l.outer_step for i in range(k))
    log_c = sorted((e["kind"], e["step"], e["bytes"])
                   for e in pool.comms.log if e["kind"] != "stats")
    log_l = sorted((e["kind"], e["step"], e["bytes"])
                   for e in pool_l.comms.log)
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(pool.global_params.values(),
                               pool_l.global_params.values()))
    # the same kernels on the same inputs in the same order: the final
    # params are held bitwise equal (a wrong outer reduction moves them by
    # about one round's update, far below any bf16 tolerance at the
    # largest weight), and every round's f32 param checksum equal
    bitwise = all(torch.equal(a, b) for a, b in zip(
        pool.global_params.values(), pool_l.global_params.values()))
    emit("cluster_sync_vs_train_adloco", losses_cluster=losses_c,
         losses_train_adloco=hist_l.loss, batches_cluster=batches_c,
         batches_train_adloco=hist_l.requested_batches,
         comm_log_equal=log_c == log_l, outer_events=len(log_c),
         param_sums_equal_every_round=sums_equal,
         final_params_max_abs_diff=diff, bitwise=bitwise)
    if losses_c != hist_l.loss or batches_c != hist_l.requested_batches \
            or log_c != log_l or not sums_equal or not bitwise:
        raise AssertionError("the sync cluster run and train_adloco "
                             "disagree")
    del pool, pool_l, hist, hist_l, inits, streams

    # 2. async + piggybacked stats on 2 pods x 2 nodes, bursty congestion
    # between the pods, traced, run twice; merging off, so every trainer
    # runs its T rounds
    pods = make_pod_profiles([2, 2], ratio=2.0)
    profiles = interleave_pods(pods)
    topo = Topology.from_profiles(pods, inter_bw=IB_NDR_BW,
                                  inter_latency=IB_NDR_LATENCY)
    round_s, sync_s = round_estimates(cfg, profiles, acfg.initial_batch_size,
                                      acfg.num_inner_steps, True, topo,
                                      profiles[:acfg.nodes_per_gpu])
    knobs = dict(start=round_s, period=sync_s / 2, burst=sync_s / 4,
                 count=6)
    runs = []                         # (trace, report): no tensors kept
    for rep_i in range(2):
        trace = Trace()
        _, _, rep, n = cluster_run(
            f"async_{rep_i}", acfg_kw={"enable_merge": False},
            policy="async", profiles=profiles, network=topo, trace=trace,
            scenario=build_scenario("bursty_congestion", **knobs))
        runs.append((trace, rep))
        launches.setdefault("async", n)
    trace, rep = runs[0]
    inside = [e for e in rep.applied_events
              if e["kind"] == "fabric" and e["time"] < rep.sim_time]
    problems = validate_perfetto(trace.to_perfetto())
    digests = [r[0].sim_digest() for r in runs]
    emit("cluster_async_checks", round_estimate_s=round_s,
         sync_estimate_s=sync_s, knobs=knobs,
         windows_inside_horizon=len(inside), perfetto_problems=problems,
         sim_digests=digests,
         summaries_equal=runs[0][1].summary() == runs[1][1].summary(),
         trace_spans=len(trace.spans), trace_events=len(trace.events))
    T = acfg.num_outer_steps
    if (any(r != T for r in rep.rounds.values()) or len(rep.rounds) != k
            or rep.num_stats_syncs <= 0 or len(inside) < 2 or problems
            or digests[0] != digests[1]
            or runs[0][1].summary() != runs[1][1].summary()):
        raise AssertionError(f"async cluster run failed its checks: "
                             f"{rep.summary(extended=True)}")
    del runs, trace

    # 3. elastic with merging: a slowdown, a leave, a join (onto the two
    # spare nodes and shards)
    profiles = make_heterogeneous_profiles(6, ratio=2.0)
    net = NetworkModel()
    round_s, _ = round_estimates(cfg, profiles, acfg.initial_batch_size,
                                 acfg.num_inner_steps, False, net,
                                 profiles[:acfg.nodes_per_gpu])
    _, stats_s = round_estimates(cfg, profiles, 0, 0, True, net,
                                 profiles[:acfg.nodes_per_gpu])
    r = round_s + stats_s                 # a round boundary, stats included
    scen = [ClusterEvent(time=0.5 * r, kind="slowdown", node=1,
                         factor=2.0, duration=r),
            ClusterEvent(time=1.2 * r, kind="leave"),
            ClusterEvent(time=1.6 * r, kind="join")]
    pool, hist, rep, launches["elastic"] = cluster_run(
        "elastic", spares=2, policy="elastic", profiles=profiles,
        network=net, scenario=scen)
    kinds = [e["kind"] for e in rep.applied_events]
    merged = sum(len(e["merged"]) for e in rep.applied_events
                 if e["kind"] == "merge")
    expect = k - kinds.count("leave") + kinds.count("join") - merged
    join = next((e for e in rep.applied_events if e["kind"] == "join"), None)
    emit("cluster_elastic_checks", round_boundary_estimate_s=r,
         events=kinds, final_pool=pool.k, expected_pool=expect,
         join=join)
    if not ({"slowdown", "leave", "join"} <= set(kinds) and join
            and join["cloned_from"] in range(k) and pool.k == expect):
        raise AssertionError(f"elastic cluster run failed its checks: "
                             f"{rep.applied_events}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi, hgmma = timed("env", phase_env)
    flash_rows = timed("kernels_flash", phase_kernels)
    flash = flash_rows[0]
    gs = timed("kernels_gradstats", phase_gradstats_kernels)
    scan, scan_hybrid = timed("kernels_scan", phase_scan_kernels)
    launches = timed("generate", phase_generate)
    timed("server", phase_server)
    ssm_launches = timed("generate_ssm", phase_generate_ssm)
    hybrid_launches = timed("generate_hybrid", phase_generate_hybrid)
    timed("prefill_f32_hybrid", phase_hybrid_f32)
    timed("server_ssm", phase_server, "falcon-mamba-7b", "mamba_scan")
    train_launches = timed("train", phase_train)
    cluster_launches = timed("cluster", phase_cluster)
    kernels = [{
        "name": "flash_attention", "route": "cuda", "source": FLASH_SRC,
        "replaces": FLASH_TPU, "launches": launches["flash_attention"],
        "launches_tc": launches["flash_attention_tc"],
        "launches_hybrid": hybrid_launches["flash_attention"],
        "launches_hybrid_tc": hybrid_launches["flash_attention_tc"],
        "path": flash["path"], "hgmma_in_sass": hgmma,
        "hybrid_ms": {("global" if r["window"] is None
                       else f"window_{r['window']}"): r["kernel_ms"]
                      for r in flash_rows if r["shape"][2] == 25},
        "max_abs_err": flash["max_abs_err"], "ms": flash["kernel_ms"],
        "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"], "library_ms": flash["library_ms"],
        "shape": flash["shape"], "dtype": flash["dtype"]}, {
        "name": "gradstats_colsum", "route": "cuda", "source": GRADSTATS_SRC,
        "replaces": COLSUM_TPU, "launches": train_launches["colsum"],
        "launches_cluster": {run: n["colsum"]
                             for run, n in cluster_launches.items()},
        "max_abs_err": gs["gbar"], "ms": gs["colsum_ms"],
        "plain_ms": gs["plain_colsum_ms"], "bound_ms": gs["colsum_bound_ms"],
        "bound_by": gs["colsum_bound_by"],
        "library_ms": gs["library_colsum_ms"], "shape": gs["shape"],
        "dtype": gs["dtype"]}, {
        "name": "gradstats_moments", "route": "cuda",
        "source": GRADSTATS_SRC, "replaces": MOMENTS_TPU,
        "launches": train_launches["moments"],
        "launches_cluster": {run: n["moments"]
                             for run, n in cluster_launches.items()},
        "max_abs_err": max(gs["s"], gs["d"], gs["n2"]),
        "max_rel_err": max(gs["s_rel"], gs["d_rel"], gs["n2_rel"]),
        "ms": gs["moments_ms"], "plain_ms": gs["plain_moments_ms"],
        "bound_ms": gs["moments_bound_ms"],
        "bound_by": gs["moments_bound_by"],
        "library_ms": gs["library_gram_ms"], "shape": gs["shape"],
        "dtype": gs["dtype"]}, {
        "name": "mamba_scan", "route": "cuda", "source": SCAN_SRC,
        "replaces": SCAN_TPU, "launches": ssm_launches["mamba_scan"],
        "launches_hybrid": hybrid_launches["mamba_scan"],
        "max_abs_err": scan["max_abs_err"], "ms": scan["kernel_ms"],
        "plain_ms": scan["plain_ms"], "bound_ms": scan["bound_ms"],
        "bound_by": scan["bound_by"], "library_ms": None,
        "shape": scan["shape"], "dtype": scan["dtype"],
        "lanes": scan["lanes"], "warps_per_sm": scan["warps_per_sm"],
        "share_of_bound": scan["share_of_bound"],
        "hybrid_ms": scan_hybrid["kernel_ms"],
        "hybrid_lanes": scan_hybrid["lanes"]}]
    print(json.dumps({"kernels": kernels,
                      "seconds": time.perf_counter() - t0}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
