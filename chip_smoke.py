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
     MicroLlama-300M, hymba-1.5b and gemma3-4b prefill shapes (flash
     attention; hymba's and gemma3-4b's (hd 256) with window 1024 and
     without; gemma3-4b's also in f32 and at a ragged S), at the training
     stats shape (8, 304,636,928) (gradstats, with a bit-identical
     repeat) and at falcon-mamba-7b's and hymba-1.5b's prefill shapes
     (the selective scan, with a bit-identical repeat, at every lane
     count it has).  Each flash row names the path that ran: ``tc``
     (bf16, hd % 16 == 0: wgmma) or ``fma`` (f32 and other bf16 head
     dims).
  2b. flash attention's training route at the benchmark's training
     shapes (stablelm-1.6b (8, 2048, 32, 32, 64), phi3-medium-14b (4,
     2048, 40, 10, 128)): the autograd wrapper the main path runs (the
     forward that saves each row's log-sum-exp, the backward kernels)
     against the plain path's autograd, both against f32
     (``tests/flash_train_card.check_grads``), then kernel / bound /
     plain / library device ms of each binding (the library's is
     ``F.scaled_dot_product_attention``'s, a yardstick the port never
     calls); every backward kernel's SASS must hold HGMMA.
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
     serving kernel never launched and every attention call took the
     training route (``flash_train_*``: forward and remat recompute,
     backward, none plain), and the kernel and plain statistics of one
     stats round's G agree.  Training rematerialises each layer in the
     backward (``models.loss_fn``'s default, as the JAX loss).  Then one
     MicroLlama-300M inner step at full width in bf16 on 8 x 1024
     tokens, where the activations outweigh the parameters and AdamW
     state, through ``models.loss_fn`` with ``remat=True`` and with
     ``remat=False``: peak memory and device ms of each, beside the
     card's name and power limit.  Fails unless both losses are equal
     and finite and the gradients agree.
  5b. banded sliding-window attention (``layers.sdpa_banded``, the
     path of a local layer of gemma3-4b or hymba-1.5b at two windows or
     more): one gemma3-4b local layer (B 1, S 8192, 8 / 4 heads, hd 256,
     window 1024) banded against masked ``sdpa``, forward and backward,
     in bf16 (within 5% of each result's largest magnitude) and f32
     (2e-5): peak above the inputs and device ms of each, the banded
     peak below the masked one; then one ``models.loss_fn`` step with
     gradients of gemma3-4b at full width in bf16 (34 layers, 1 x 8192
     tokens, remat) banded and with every local layer masked: finite
     losses within 5%, 2 banded calls per local layer (forward and
     recompute), peak memory and device ms of each.

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

  6b. the multi-process backend: two fresh interpreters
     (``chip_smoke.py --cluster-mp-worker``), each one worker of
     microllama-300m at full width in bf16 on the one card,
     joined by gloo, run ``run_cluster`` with a ``TorchProcessBackend``
     on phase 6's settings cut to k=1 x M=2, adaptive with the
     microbatch estimator: ``sync`` against ``SimBackend`` in this
     process on the same inputs (requested batches, modes, simulated
     time and every round's f32 param checksum equal, final params
     bitwise equal); ``async``, traced (the sim digest equal, real
     overlap > 0, one ``piggyback`` span per stats sync and no
     ``stats`` span); the backend in one process (k=1 x M=1, the
     per-sample probe) bitwise equal to ``SimBackend``, with one launch
     of each gradstats kernel per stats reduction; then each example of
     ``repro_torch.examples`` in a fresh interpreter on the card
     (``train_100m --demo``), which must exit 0.  Its wall times and
     ``real_comm_time`` are gloo over loopback between two processes on
     one card, not the speed of a collective.

  7. the chunked per-sample probe: 64 rows of microllama-300m's
     gradient at full width in bf16, whose one-pass G (78 GB) does not
     fit the card, in row chunks: one launch of each gradstats kernel
     per chunk and sweep, peak under the card's memory, kernel and plain
     statistics (same chunks) within 1e-4; an 8-row probe in one pass
     against 3-row chunks.
  8. training the hybrid and SSM families: ``launch.train.run`` on
     hymba-1.5b at full width and falcon-mamba-7b cut to 8 of 64 layers
     (widths unchanged), bf16 with f32 AdamW state, k=1, M=2, three
     rounds: finite losses, a probe in row chunks, gradstats launches =
     probe chunks (each sweep), no flash or scan launch; peak memory.
  9. serving the other dense configs and the MoE family:
     ``serve.generate`` in bf16 at full width on qwen3-0.6b, gemma3-4b
     (2 x 2048, past its window, flash at hd 256), stablelm-1.6b,
     phi3-medium-14b and deepseek-moe-16b, one at a time: flash on the
     tensor-core path once per layer, kernel prefill within 5% of the
     plain prefill's largest logit, ids in range; prefill and decode
     times, peak memory.
  10. the encoder-decoder and the VLM prefix: ``serve.generate`` on
     whisper-small at full width in bf16 (12 + 12 layers, 4 x 1500
     seeded frames, 4-token prompts teacher-forced, 32 greedy tokens;
     flash on the tensor-core path once per encoder layer, kernel and
     plain encoder states and first logits within 5% of their largest
     magnitude; in f32 the kernel and plain greedy tokens equal, excused
     only at a near-tie) and on phi-3-vision-4.2b at full width in bf16
     (32 layers, a seeded (2, 576, 3072) patch prefix before 2 prompts
     of 512 tokens, 32 greedy tokens; flash on the tensor-core path once
     per layer, kernel prefill within 5%).
  11. training them: whisper-small at full width, 3 AdamW inner steps
     (``core.diloco.make_inner_step`` over ``models.loss_fn``) on 4 x
     (1500 frames, 128 tokens); phi-3-vision-4.2b through
     ``launch.train`` cut to 8 of its 32 layers (text-only, as the JAX
     launcher; in phase 8's list) and one inner step of the same cut
     model on a batch with a 576-token prefix.  Finite losses, params
     that move, no launch of flash's serving call or the scan (the
     flash training route counted apart); device ms and peak memory.

  12. the analysis layer: ``python -m repro_torch.launch.dryrun`` for
     microllama-300m's four shapes and the train_4k of phi3-medium-14b
     and grok-1-314b (FSDP) and qwen3-0.6b, falcon-mamba-7b's
     long_500k (its Mamba step on the model axis's channels),
     gemma3-4b's prefill_32k and train_4k (banded local layers), the
     prefills that trace a scan or a sharded cache, and one combo of
     each kind torch 2.11 once
     refused (qwen3-0.6b decode_32k, deepseek-moe-16b prefill_32k,
     whisper-small train_4k, hymba-1.5b long_500k) on the h100_32x8
     mesh, and six combos again as the baseline (``REPRO_BASELINE=1``,
     no activation constraints, full prefill logits; the two MoE train
     steps among them), each in a fresh
     interpreter (eight at a time): one line per combo (status
     and torch version; per-card FLOPs, bytes, wire and temp bytes, or
     the op an error names), each baseline count beside the policy's,
     and the roofline rows of ``launch.roofline``; the phase fails if a
     combo errors or a pinned combo counts other FLOPs than torch
     2.13 does on the CPU.  Then the count
     held against the card on the (1, 1) ``make_host_mesh()``: the dry
     run's own programs at one card's shapes (MicroLlama-300M bf16
     prefill of 4 x 512 with last-token logits; one AdamW inner step at
     seq 128, batch 8), counted on meta tensors and again on the card
     (the FLOPs must be equal; the inner step's attention takes flash's
     training route on the card, whose launches the count cannot see,
     so there every call must be on the route and the card's count
     below the meta one, the plain program's), the predicted peak
     (arguments + temp) against ``max_memory_allocated``, and the
     device time against the roofline bound of the card's count (the
     phase fails if a bound exceeds its measured time: a count above
     what the card did is a wrong count).

A phase alone: ``python3 -c 'import sys; sys.path.insert(0, "."); import
chip_smoke as cs; cs.phase_probe()'`` from the root (each phase builds
the kernels it needs at first use); ``cs.phase_generate_encdec()``,
``cs.phase_generate_vlm()`` and ``cs.phase_cluster_mp()`` the same way.

Then the ``kernels`` summary line (flash with its launches per path and
model, its hd-256 times and its times at whisper-small's encoder and
phi-3-vision's prefill, and the serving examples' launches; gradstats
with the training, cluster, one-process backend, probe and
family-training launches), the card's name and power limit,
and
last ``{"ok": true, "device": {...}}``.  Without a card (or without the
repository around it) it exits non-zero and prints no result.

TF32 is switched off for matmuls and cuDNN, so every f32 product runs in
full f32 and f32 comparisons measure the kernels, not TF32 rounding.
The caching allocator runs with expandable segments (unless
``PYTORCH_CUDA_ALLOC_CONF`` says otherwise), as the training launcher
sets it: full-width training of hymba-1.5b leaves gigabytes cached but
unusable between live tensors otherwise.

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
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack, contextmanager
from pathlib import Path

# read when the CUDA allocator starts, so set before torch touches CUDA
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

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


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def phase_env():
    smi = smi_line()
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
                 if any(w in line for w in ("entry function", "registers",
                                            "spill"))]
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
    return sum(sass_by_function(lib, opcode).values())


# the Pallas kernel pads S to a multiple of its 128-key tile
PAD_TILE = 128


def padding_check(q, k, v, out, w) -> dict:
    """Whether a bidirectional ``out`` masks the keys past a ragged S.
    Left unmasked, the zero keys that pad S to ``PAD_TILE`` only rescale
    each row (by about 1.5% at S = 1500), within ``TOL``; so the RMS of
    out - ref, both against the plain version in f32, must stay under 1%
    of ref's and under half that of the plain version run with the
    padding as keys (the fault of the Pallas kernel, ROADMAP 3.6)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    S, pad = q.shape[1], -q.shape[1] % PAD_TILE
    q, k, v = (t.float() for t in (q, k, v))
    ref = flash_attention_ref(q, k, v, causal=False, window=w)
    unmasked = flash_attention_ref(
        *(F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v)),
        causal=False, window=w)[:, :S]

    def rms(t):
        return t.pow(2).mean().sqrt().item()

    err_rms, ref_rms = rms(out.float() - ref), rms(ref)
    unmasked_rms = rms(unmasked - ref)
    return dict(rel_rms_err=err_rms / ref_rms,
                unmasked_padding_rel_rms=unmasked_rms / ref_rms,
                padding_ok=err_rms < 1e-2 * ref_rms
                and err_rms < 0.5 * unmasked_rms)


def phase_kernels():
    """Flash kernel against its plain version; times at the MicroLlama,
    hymba-1.5b and gemma3-4b prefill shapes.  Returns the timed rows,
    MicroLlama's B=4 first."""
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
        # gemma3-4b's prefill shape at hd 256: the tensor-core kernel's
        # 256-wide tile, global and windowed; f32 and bf16 hd 136 on the
        # FMA kernel's 256-wide tile; hd 256 at a ragged S; hd 192 (the
        # 256-wide tile zero-filled past hd)
        (2, 2048, 8, 4, 256, None, True, bf16, True),  # gemma3-4b global
        (2, 2048, 8, 4, 256, 1024, True, bf16, True),  # gemma3-4b local
        (2, 2048, 8, 4, 256, None, True, f32, False),
        (2, 2000, 8, 4, 256, None, True, bf16, False),
        (1, 300, 8, 4, 256, 100, True, f32, False),
        (1, 200, 4, 2, 192, 100, True, bf16, False),
        (1, 96, 4, 2, 136, None, True, bf16, False),
        # whisper-small's encoder: bidirectional over 1500 frames, whose
        # last key tile is ragged, H = Hk; phi-3-vision's prefill (576
        # patches + 512 tokens) at hd 96 (the 128-wide tile zero-filled
        # past hd); ragged, bidirectional and hd 96 at once
        (4, 1500, 12, 12, 64, None, False, bf16, True),  # whisper encoder
        (4, 1500, 12, 12, 64, None, False, f32, False),
        (2, 1088, 32, 32, 96, None, True, bf16, True),   # phi-3-vision
        (1, 200, 4, 4, 96, None, False, bf16, False),
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
                   launches_by_path=ran, max_abs_err=err, tol=TOL[dt])
        if not causal and S % PAD_TILE:
            row.update(padding_check(q, k, v, out, w))
            ok = ok and row["padding_ok"]
        row["ok"] = ok
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



def sass_by_function(lib: Path, opcode: str) -> dict:
    """Lines holding ``opcode`` in each function of ``cuobjdump -sass
    lib``, by the function's (mangled) name."""
    from repro_torch.kernels._build import nvcc_path
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and opcode in line:
            counts[fn] += 1
    return counts


# the training shapes (B, S, H, Hk, hd) of the benchmark's cells:
# stablelm-1.6b at b 8, phi3-medium-14b at b 4
TRAIN_ATTN_SHAPES = {"stablelm-1.6b": (8, 2048, 32, 32, 64),
                     "phi3-medium-14b": (4, 2048, 40, 10, 128)}


def attn_train_bounds(B, S, H, Hk, hd) -> dict:
    """Bound ms of the training forward (2 products) and backward (5
    products) of causal attention: FLOPs 2 B H S^2 hd per product over
    the half square, at the bf16 peak, beside the bytes term (forward:
    q, k, v read, o and the log-sum-exp written; backward: q, k, v, o,
    dO and the log-sum-exp read, dq, dk, dv written)."""
    flops = 2 * B * H * S * S * hd / 2
    elem = 2
    qb, kvb, lse = B * S * H * hd * elem, B * S * Hk * hd * elem, B * H * S * 4
    out = {}
    for name, products, nbytes in (
            ("fwd", 2, 2 * qb + 2 * kvb + lse),
            ("bwd", 5, 3 * qb + 2 * kvb + lse + qb + 2 * kvb)):
        t_ops = products * flops / PEAK_FLOPS[torch.bfloat16]
        t_bytes = nbytes / PEAK_BYTES
        out[name] = dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                         ops_ms=t_ops * 1e3, bytes_ms=t_bytes * 1e3,
                         flops=products * flops, bytes=nbytes,
                         bound_by="operations" if t_ops >= t_bytes
                         else "bytes")
    return out


def phase_flash_train() -> list:
    """The training route of flash attention at the benchmark's two
    training shapes.  First the wrapper the main path runs
    (``ops.flash_attention_train`` under autograd: its copies, saved
    tensors and gradients) against the plain path's autograd
    (``layers.sdpa``), both against f32, by ``flash_train_card.
    check_grads``, the one check and tolerance the ``gpu`` tests use at
    their smaller shapes.  Then the device ms of the bindings alone (the
    tensor-core forward with its log-sum-exp, the backward kernels)
    beside the bound, the plain autograd's and the library's
    (``F.scaled_dot_product_attention``, a yardstick the port never
    calls).  HGMMA must be in the SASS of every backward kernel."""
    import torch.nn.functional as F
    from repro_torch.kernels._build import build
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.models.layers import sdpa
    sys.path.insert(0, str(ROOT / "tests"))
    import flash_train_card

    sass = sass_by_function(build("flash_attention").path, "HGMMA")
    bwd_sass = {fn: n for fn, n in sass.items() if "flash_bwd" in fn}
    emit("flash_train_sass", hgmma_by_backward_kernel=bwd_sass)
    if len(bwd_sass) < 4 or not all(bwd_sass.values()):
        raise AssertionError(f"a backward kernel holds no HGMMA: {bwd_sass}")
    rows = []
    for arch, shape in TRAIN_ATTN_SHAPES.items():
        grads = flash_train_card.check_grads(shape)
        emit("flash_train_grads", arch=arch, **grads)
        torch.cuda.empty_cache()
        q, k, v, do = flash_train_card.inputs(*shape)
        o, lse = kernel.flash_attention_fwd_lse(q, k, v)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        plain = sdpa(*leaves, causal=True)
        lib_in = [t.detach().transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v)]
        lib = F.scaled_dot_product_attention(*lib_in, is_causal=True,
                                             enable_gqa=True)
        do_t = do.transpose(1, 2).contiguous()
        bounds = attn_train_bounds(*shape)
        row = dict(
            arch=arch, shape=list(shape), dtype="bfloat16",
            fwd_kernel_ms=device_ms(
                lambda: kernel.flash_attention_fwd_lse(q, k, v)),
            bwd_kernel_ms=device_ms(
                lambda: kernel.flash_attention_bwd(q, k, v, o, lse, do)),
            fwd_plain_ms=device_ms(lambda: sdpa(q, k, v, causal=True),
                                   iters=5),
            bwd_plain_ms=device_ms(lambda: torch.autograd.grad(
                plain, leaves, do, retain_graph=True), iters=5),
            fwd_library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                *(t.detach() for t in lib_in), is_causal=True,
                enable_gqa=True)),
            bwd_library_ms=device_ms(lambda: torch.autograd.grad(
                lib, lib_in, do_t, retain_graph=True)),
            fwd_bound=bounds["fwd"], bwd_bound=bounds["bwd"],
            nvidia_smi=smi_line())
        row["fwd_share_of_bound"] = (bounds["fwd"]["bound_ms"]
                                     / row["fwd_kernel_ms"])
        row["bwd_share_of_bound"] = (bounds["bwd"]["bound_ms"]
                                     / row["bwd_kernel_ms"])
        emit("flash_train", **row)
        rows.append({**row, "grads": grads})
        del plain, lib, leaves, lib_in
        torch.cuda.empty_cache()
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
            "flash_train_fwd": flash.train_fwd_launches,
            "flash_train_bwd": flash.train_bwd_launches,
            "flash_train_plain": flash.train_plain_calls,
            "mamba_scan": scan.scan_launches,
            "gradstats_colsum": gs.colsum_launches,
            "gradstats_moments": gs.moments_launches}


def reset_counts():
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.gradstats import ops as gs
    from repro_torch.kernels.mamba_scan import ops as scan
    flash.launches = flash.tc_launches = flash.fma_launches = 0
    flash.reset_train_counts()
    scan.scan_launches = 0
    gs.colsum_launches = gs.moments_launches = 0


@contextmanager
def only_kernel(name):
    """While active, ``prefill(use_kernels=True)`` runs the kernel
    ``name`` alone (None: no kernel): every other wrapper is swapped for
    the plain function that the plain prefill calls in its place."""
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
                   rel_tol: float, prefix_emb=None):
    """Last-position logits of the kernel prefill against the plain
    prefill's, held within ``rel_tol`` of the plain logits' largest
    magnitude.  Where the path runs several ``kernels``, each also runs
    alone, so a gap is traced to one kernel.  Returns (row, faults)."""
    from repro_torch import models

    def last(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = models.prefill(params, prompts, cfg, cache_len,
                                   prefix_emb=prefix_emb, last_only=True,
                                   **kw)
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


@contextmanager
def moe_routes(store: list, replay: bool):
    """While active, each MoE block's routing (``layers.moe_route``) is
    appended to ``store``, or (``replay``) taken from ``store`` in call
    order instead of computed."""
    from repro_torch.models import layers as L

    orig = L.moe_route
    stored = iter(list(store))

    def hooked(p, x, cfg, **kw):
        if replay:
            return next(stored)
        r = orig(p, x, cfg, **kw)
        store.append(r)
        return r

    L.moe_route = hooked
    try:
        yield
    finally:
        L.moe_route = orig


def moe_prefill_parity(params, cfg, prompts, cache_len: int,
                       rel_tol: float):
    """``prefill_parity`` for a MoE model.  A token whose top-k experts
    sit within rounding of each other can route differently in the
    kernel and plain prefills (bf16 hidden states that differ in the
    last bits), and one flipped expert moves the logits far more than
    the attention kernel's rounding.  So the kernel prefill is held to
    the plain one with the plain prefill's routing replayed, within
    ``rel_tol`` of the plain logits' largest magnitude; the free-running
    gap and the number of tokens whose expert set flipped are reported
    beside it.  Returns (row, faults)."""
    from repro_torch import models

    def last(use_kernels, store, replay):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with moe_routes(store, replay):
            logits, _ = models.prefill(params, prompts, cfg, cache_len,
                                       last_only=True,
                                       use_kernels=use_kernels)
        torch.cuda.synchronize()
        return logits[:, -1].float(), time.perf_counter() - t0

    plain_routes, kernel_routes = [], []
    lp, plain_s = last(False, plain_routes, False)
    lk_free, kernel_s = last(True, kernel_routes, False)
    lk, _ = last(True, plain_routes, True)
    flips = sum(int((torch.sort(a.topi, -1).values
                     != torch.sort(b.topi, -1).values).any(-1).sum())
                for a, b in zip(plain_routes, kernel_routes))
    scale = lp.abs().max().item()
    tol = rel_tol * scale
    err = (lk - lp).abs().max().item()
    row = dict(kernel_prefill_wall_s=kernel_s, plain_prefill_wall_s=plain_s,
               logits_finite=bool(torch.isfinite(lk_free).all()),
               last_logits_max_abs_err=err,
               free_running_max_abs_err=(lk_free - lp).abs().max().item(),
               routed_tokens=sum(r.topi.shape[0] for r in plain_routes),
               tokens_whose_experts_flipped=flips,
               last_logits_scale=scale, rel_tol=rel_tol, tol=tol,
               greedy_next_token_agrees=int(
                   (lk.argmax(-1) == lp.argmax(-1)).sum()))
    faults = [] if row["logits_finite"] else ["non-finite logits from the "
                                              "kernel prefill"]
    if err > tol:
        faults.append(f"kernel prefill logits (plain routing replayed) "
                      f"differ from the plain prefill by {err} > {tol}")
    return row, faults


def check_ids(res, cfg, B: int, new: int):
    toks = torch.tensor(res.tokens)
    if toks.shape != (B, new) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name}: bad generated ids, shape "
                             f"{tuple(toks.shape)}")


def gen_times(res, wall_s: float, B: int, S: int, new: int):
    """``generate``'s times; S counts the positions before the first
    token (frames or prefix, and the prompt)."""
    return dict(wall_s=wall_s, prefill_ms=res.prefill_ms,
                decode_ms=res.decode_ms,
                decode_ms_per_step=res.decode_ms / (new - 1),
                prefill_tok_per_s=B * S / res.prefill_ms * 1e3,
                decode_tok_per_s=B * (new - 1) / res.decode_ms * 1e3)


@torch.inference_mode()
def generate_main_path(arch: str, B: int, S: int, new: int, expect: dict,
                       prefix: int = 0):
    """``serve.generate`` on ``arch`` at full width in bf16 (seeded
    random weights; ``prefix`` > 0: a seeded (B, prefix, d) patch
    prefix before the prompts), with every launch count set to 0 just
    before the call and read just after; each must equal ``expect``.
    Then the kernel prefill's last logits against the plain prefill's,
    within 5% of their largest magnitude.  Returns the launch counts and
    (cfg, params, prompts, result)."""
    from repro_torch import models, serve
    from repro_torch.configs import get_config

    cfg = get_config(arch)                                   # bf16
    t0 = time.perf_counter()
    params = models.init_params(cfg, 0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device="cuda")
    prefix_emb = (torch.randn((B, prefix, cfg.d_model), generator=gen,
                              device="cuda").to(params.embed.dtype)
                  if prefix else None)
    serve.generate(params, cfg, prompts, max_new_tokens=2,
                   prefix_emb=prefix_emb)                    # warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = serve.generate(params, cfg, prompts, max_new_tokens=new,
                         prefix_emb=prefix_emb)
    wall_s = time.perf_counter() - t0        # ends in a device->host copy
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_ids(res, cfg, B, new)

    # bf16: the plain path rounds the softmax probabilities to bf16
    # before the PV product and forms a block of scan steps at once, the
    # kernels keep f32 and sum in another order; the layers' bf16
    # residuals carry that to the logits
    if cfg.moe is not None:
        row, faults = moe_prefill_parity(params, cfg, prompts, S + new,
                                         5e-2)
    else:
        row, faults = prefill_parity(
            params, cfg, prompts, prefix + S + new,
            [k for k in ("flash_attention", "mamba_scan") if expect[k]],
            5e-2, prefix_emb=prefix_emb)
    emit("generate", arch=cfg.name, dtype=cfg.dtype, layers=cfg.num_layers,
         d_model=cfg.d_model, params=cfg.param_count(), batch=B, prompt=S,
         prefix=prefix, new_tokens=new, setup_s=setup_s, launches=launches,
         expected_launches=expect,
         **gen_times(res, wall_s, B, prefix + S, new),
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
    flash_ops.reset_train_counts()
    gs_ops.colsum_launches = gs_ops.moments_launches = 0
    t0 = time.perf_counter()
    with compare_one_stats_round(rec):
        pool, hist, cfg = train.run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"colsum": gs_ops.colsum_launches,
                "moments": gs_ops.moments_launches,
                "flash_attention": flash_ops.launches,
                "flash_train_fwd": flash_ops.train_fwd_launches,
                "flash_train_bwd": flash_ops.train_bwd_launches,
                "flash_train_plain": flash_ops.train_plain_calls}
    peak = torch.cuda.max_memory_allocated()
    for i, t in enumerate(hist.outer_step):
        emit("train_round", run=label, round=t, loss=hist.loss[i],
             requested_batches=hist.requested_batches[i],
             modes=hist.modes[i], pool_size=hist.pool_size[i],
             comm_events=hist.comm_events[i], wall_s=hist.wall[i],
             stats_probe=hist.stats_probe[i], device_ms=hist.phase_ms[i])
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
        raise AssertionError(f"{label}: training launched the flash "
                             "serving kernel")
    # every attention call on the training route, each remat layer's
    # forward twice (the recompute)
    if not (launches["flash_train_fwd"] == 2 * launches["flash_train_bwd"]
            > 0 and launches["flash_train_plain"] == 0):
        raise AssertionError(f"{label}: training attention off the "
                             f"kernels' route: {launches}")
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


REMAT_BATCH, REMAT_SEQ = 8, 1024


def phase_remat() -> dict:
    """One AdamW inner step of MicroLlama-300M at full width in bf16 on
    ``REMAT_BATCH`` x ``REMAT_SEQ`` tokens (full logits), its loss
    ``models.loss_fn`` with ``remat=True`` (the default: each layer
    recomputed in the backward) and with ``remat=False`` (every layer's
    activations kept): the allocator's peak over the first step and the
    step's device ms.  Fails unless both losses are equal and finite and
    each gradient agrees within the bf16 tolerance of its largest
    entry."""
    from repro_torch import models, optim
    from repro_torch.configs import get_config
    from repro_torch.core.diloco import make_inner_step

    cfg = get_config("microllama-300m")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    params = models.lm.param_dict(models.init_params(cfg, 0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (1, REMAT_BATCH, REMAT_SEQ),
                                     generator=gen, device="cuda")}
    opt = optim.adamw(3e-4)
    state = opt.init(params)
    rows, out = {}, {}
    for remat in (True, False):
        step = make_inner_step(
            lambda p, b: models.loss_fn(p, b, cfg, remat=remat), opt, 1)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, _, loss, grads = step(params, state, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        out[remat] = (loss, grads)
        ms = device_ms(lambda: step(params, state, batch), iters=5,
                       warmup=1)
        rows["remat" if remat else "no_remat"] = {
            "max_memory_allocated": peak, "above_inputs": peak - before,
            "device_ms": ms, "loss": float(loss)}
    (loss, grads), (loss_k, grads_k) = out[True], out[False]
    bitwise = all(torch.equal(grads[k], grads_k[k]) for k in grads)
    worst = max(((grads[k].float() - grads_k[k].float()).abs().max()
                 / grads_k[k].float().abs().max().clamp_min(1e-30)).item()
                for k in grads)
    emit("train_remat", arch=cfg.name, dtype=cfg.dtype,
         tokens=[REMAT_BATCH, REMAT_SEQ], nvidia_smi=smi_line(),
         torch=torch.__version__, grads_bitwise_equal=bitwise,
         max_rel_grad_gap=worst, **rows)
    if not (torch.equal(loss, loss_k) and math.isfinite(float(loss))):
        raise AssertionError(f"remat loss {float(loss)} != "
                             f"{float(loss_k)} without remat")
    if worst > TOL[torch.bfloat16]:
        raise AssertionError(f"remat gradients differ by {worst} of the "
                             "largest entry")
    del params, state, grads, grads_k, out
    torch.cuda.empty_cache()
    return rows


# one gemma3-4b local attention layer: (B, S, H, Hk, hd) and its window
BANDED_SHAPE, BANDED_WINDOW = (1, 8192, 8, 4, 256), 1024
# banded against masked, of the largest magnitude (outputs and gradients)
BANDED_TOL = {torch.bfloat16: 5e-2, torch.float32: 2e-5}


@contextmanager
def local_layers_masked():
    """While active, every local layer attends masked over the whole
    sequence (``layers.plan_window`` never asks for the banded path)."""
    from repro_torch.models import layers as L

    plan = L.plan_window
    L.plan_window = lambda *args: (plan(*args)[0], False)
    try:
        yield
    finally:
        L.plan_window = plan


@contextmanager
def counting_banded(calls: list):
    """While active, each ``layers.sdpa_banded`` call appends its query
    rows to ``calls``."""
    from repro_torch.models import layers as L

    banded = L.sdpa_banded

    def counted(q, *args, **kwargs):
        calls.append(q.shape[1])
        return banded(q, *args, **kwargs)

    L.sdpa_banded = counted
    try:
        yield
    finally:
        L.sdpa_banded = banded


def banded_layer(dtype) -> dict:
    """``layers.sdpa_banded`` against masked ``layers.sdpa`` on one
    gemma3-4b local layer (``BANDED_SHAPE``, seeded inputs in ``dtype``),
    forward and backward (q, k and v's gradients of a seeded cotangent):
    each variant's peak above its inputs and device ms, and the largest
    gap of each result over the masked one's largest magnitude."""
    from repro_torch.models import layers as L

    B, S, H, Hk, hd = BANDED_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)

    def t(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, k, v, cot = t(B, S, H, hd), t(B, S, Hk, hd), t(B, S, Hk, hd), \
        t(B, S, H, hd)
    attend = {"banded": lambda *x: L.sdpa_banded(*x, window=BANDED_WINDOW),
              "masked": lambda *x: L.sdpa(*x, causal=True,
                                          window=BANDED_WINDOW)}
    rows, outs = {}, {}
    for name, fn in attend.items():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]

        def run():
            out = fn(*leaves)
            return (out.detach(), *torch.autograd.grad(out, leaves, cot))

        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        outs[name] = run()
        torch.cuda.synchronize()
        rows[name] = {
            "above_inputs": torch.cuda.max_memory_allocated() - before,
            "device_ms": device_ms(run, iters=5, warmup=1)}
    gaps = {part: ((a.float() - b.float()).abs().max()
                   / b.float().abs().max()).item()
            for part, a, b in zip(("out", "dq", "dk", "dv"),
                                  outs["banded"], outs["masked"])}
    return {"dtype": str(dtype).replace("torch.", ""), **rows,
            "max_rel_gap": gaps, "tol": BANDED_TOL[dtype]}


BANDED_STEP_SEQ = 8192


def phase_banded() -> dict:
    """Banded sliding-window attention, the path of every local layer of
    gemma3-4b and hymba-1.5b where S is two windows or more: one
    gemma3-4b local layer (``banded_layer``) in bf16 and f32, then one
    ``models.loss_fn`` step with gradients of gemma3-4b at full width in
    bf16 (34 layers, 1 x ``BANDED_STEP_SEQ`` tokens, remat, the dry
    run's 512-row logit chunks) through the banded path and with every
    local layer masked: finite and equal losses, the banded path taken
    on each of the 29 local layers (forward and recompute), peak memory
    and device ms of each.  Fails unless banded and masked agree within
    ``BANDED_TOL`` and the banded layer peaks below the masked one."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.core.diloco import value_and_grad

    layers = [banded_layer(dt) for dt in (torch.bfloat16, torch.float32)]
    for row in layers:
        emit("banded_layer", shape=list(BANDED_SHAPE), window=BANDED_WINDOW,
             nvidia_smi=smi_line(), torch=torch.__version__, **row)
        bad = {p: g for p, g in row["max_rel_gap"].items() if g > row["tol"]}
        if bad:
            raise AssertionError(f"banded attention differs from masked in "
                                 f"{row['dtype']}: {bad}")
        if row["banded"]["above_inputs"] >= row["masked"]["above_inputs"]:
            raise AssertionError(f"banded peak not below masked: {row}")

    cfg = get_config("gemma3-4b")
    gc.collect()
    torch.cuda.empty_cache()
    params = models.lm.param_dict(models.init_params(cfg, 0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, BANDED_STEP_SEQ),
                                     generator=gen, device="cuda")}

    def step():
        return value_and_grad(
            lambda p, b: models.loss_fn(p, b, cfg, logit_chunk=512),
            params, batch)

    steps, losses, calls = {}, {}, []
    for name in ("banded", "masked"):
        with ExitStack() as stack:
            stack.enter_context(counting_banded(calls) if name == "banded"
                                else local_layers_masked())
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            loss, _, grads = step()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            del grads
            if name == "banded":
                banded_calls = len(calls)
            ms = device_ms(step, iters=3, warmup=1)
        losses[name] = float(loss)
        steps[name] = {"loss": float(loss), "max_memory_allocated": peak,
                       "above_inputs": peak - before, "device_ms": ms}
    local = cfg.num_layers - cfg.num_layers // cfg.global_every
    emit("banded_train_step", arch=cfg.name, dtype=cfg.dtype,
         tokens=[1, BANDED_STEP_SEQ], local_layers=local,
         banded_calls_first_step=banded_calls, nvidia_smi=smi_line(),
         torch=torch.__version__, **steps)
    if not all(math.isfinite(x) for x in losses.values()):
        raise AssertionError(f"gemma3-4b step loss not finite: {losses}")
    if abs(losses["banded"] - losses["masked"]) > \
            BANDED_TOL[torch.bfloat16] * abs(losses["masked"]):
        raise AssertionError(f"banded and masked losses differ: {losses}")
    if banded_calls != 2 * local:
        raise AssertionError(f"{banded_calls} banded calls in one step, "
                             f"not 2 x {local} local layers")
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"layer": layers, "step": steps}


PROBE_ROWS, PROBE_SEQ = 64, 128
STATS_NAMES = ("mean_norm2", "sigma2", "ip_var", "orth_var", "b")


def phase_probe():
    """The per-sample probe at the launcher's default cap: 64 rows of
    MicroLlama-300M's gradient at full width in bf16 (seq 128), whose
    (64, 304,636,928) f32 G (78 GB) does not fit the card.  It runs in
    row chunks (``batching.per_sample_probe``), with the gradstats
    counts set to 0 just before and read just after: one launch of each
    kernel per chunk and sweep, and a peak under the card's memory.  The
    plain version in the same chunks must agree within 1e-4 relative.
    Then a probe of 8 rows, which fits: one pass against 3-row chunks on
    the kernel route, within 1e-4 relative (the column sums add the
    rows in the one-pass order; the gradients are recomputed)."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.core import batching
    from repro_torch.kernels.gradstats import ops as gs_ops
    from repro_torch.launch.train import build_loss_fn
    from repro_torch.models import lm

    cfg = get_config("microllama-300m")
    params = lm.param_dict(models.init_params(cfg, 0))
    loss_fn = build_loss_fn(cfg)
    gen = torch.Generator(device="cuda").manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (PROBE_ROWS, PROBE_SEQ), generator=gen,
                                     device="cuda")}
    D = sum(p.numel() for p in params.values())
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gs_ops.colsum_launches = gs_ops.moments_launches = 0
    t0 = time.perf_counter()
    res = batching.per_sample_probe(loss_fn, params, batch, use_kernel=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"colsum": gs_ops.colsum_launches,
                "moments": gs_ops.moments_launches}
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    plain = batching.per_sample_probe(loss_fn, params, batch,
                                      use_kernel=False, rows=res.rows)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    rec = {"kernel": [float(v) for v in res.stats],
           "plain": [float(v) for v in plain.stats]}
    small = {k: v[:8] for k, v in batch.items()}
    one = batching.per_sample_probe(loss_fn, params, small, use_kernel=True)
    three = batching.per_sample_probe(loss_fn, params, small,
                                      use_kernel=True, rows=3)
    small_rec = {"kernel": [float(v) for v in three.stats],
                 "plain": [float(v) for v in one.stats]}
    emit("probe", arch=cfg.name, dtype=cfg.dtype, rows=PROBE_ROWS,
         seq=PROBE_SEQ, D=D, one_pass_G_bytes=4 * PROBE_ROWS * D,
         card_bytes=total, rows_per_chunk=res.rows, chunks=res.chunks,
         launches=launches, max_memory_allocated=peak, wall_s=wall,
         plain_wall_s=plain_wall, stats_kernel=dict(zip(STATS_NAMES,
                                                        rec["kernel"])),
         stats_plain=dict(zip(STATS_NAMES, rec["plain"])),
         stats_agree=stats_agree(rec),
         small_one_pass=dict(zip(STATS_NAMES, small_rec["plain"])),
         small_chunks_of_3=dict(zip(STATS_NAMES, small_rec["kernel"])),
         small_agree=stats_agree(small_rec),
         small_bit_identical=small_rec["kernel"] == small_rec["plain"])
    faults = []
    if res.chunks < 2:
        faults.append(f"the 64-row probe must run in chunks: {res.chunks}")
    if launches != {"colsum": res.chunks, "moments": res.chunks}:
        faults.append(f"gradstats launches {launches}, expected one per "
                      f"chunk and sweep ({res.chunks})")
    if peak >= total:
        faults.append(f"peak {peak} >= the card's {total}")
    if not stats_agree(rec) or not stats_agree(small_rec):
        faults.append("chunked statistics disagree")
    if (one.chunks, three.chunks) != (1, 3):
        faults.append(f"8-row probe ran {one.chunks} / {three.chunks} "
                      f"chunks, expected 1 / 3")
    if faults:
        raise AssertionError(f"probe: {faults}")
    del params, batch
    torch.cuda.empty_cache()
    return dict(launches, chunks=res.chunks, rows=res.rows)


def run_training_family(label: str, argv, must_chunk: bool = True):
    """One ``launch.train.run`` of a non-dense family on the card, with
    the launch counts set to 0 just before and read just after.  Fails
    unless the losses and final parameters are finite, each gradstats
    kernel launched once per probe chunk and sweep, at least one probe
    ran in row chunks (where ``must_chunk``: its G does not fit beside
    the workers), and neither flash's serving call nor the scan kernel
    launched (training runs the associative scan, and attention on the
    plain path or the flash training route, counted apart)."""
    from repro_torch.launch import train

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    pool, hist, cfg = train.run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for i, t in enumerate(hist.outer_step):
        emit("train_round", run=label, round=t, loss=hist.loss[i],
             requested_batches=hist.requested_batches[i],
             modes=hist.modes[i], stats_probe=hist.stats_probe[i],
             wall_s=hist.wall[i], device_ms=hist.phase_ms[i])
    finite = all(bool(torch.isfinite(v.float()).all())
                 for v in pool.global_params.values())
    probes = [p for ps in hist.stats_probe for p in ps]
    chunks = sum(c for _, _, c in probes)
    emit("train", run=label, arch=cfg.name, dtype=cfg.dtype,
         layers=cfg.num_layers, d_model=cfg.d_model,
         params=cfg.param_count(), argv=argv, wall_s=wall,
         max_memory_allocated=peak, losses=hist.loss, launches=launches,
         probes=probes, expected_gradstats_launches=chunks,
         final_params_finite=finite)
    faults = []
    if not all(math.isfinite(x) for x in hist.loss) or not finite:
        faults.append("non-finite loss or parameters")
    if not (launches["gradstats_colsum"] == launches["gradstats_moments"]
            == chunks > 0):
        faults.append(f"gradstats launches {launches} against {chunks} "
                      f"probe chunks")
    if must_chunk and not any(c > 1 for _, _, c in probes):
        faults.append(f"no probe ran in row chunks: {probes}")
    if launches["flash_attention"] or launches["mamba_scan"]:
        faults.append(f"training launched a forward-only kernel: {launches}")
    if faults:
        raise AssertionError(f"{label}: {faults}")
    del pool, hist
    torch.cuda.empty_cache()
    return {"colsum": launches["gradstats_colsum"],
            "moments": launches["gradstats_moments"], "chunks": chunks}


# hymba-1.5b at full width; falcon-mamba-7b cut to 8 of its 64 layers
# (widths unchanged: 7.27 B parameters with f32 AdamW state do not fit one
# card).  One trainer of two workers; seq 32 keeps the associative
# scan's saved (B, S, di, n) f32 passes small.  Switch mode is off, so
# a step never accumulates beyond max_batch (an accumulating step holds
# two more f32 copies of the gradients beside AdamW's out-of-place
# update, more than the card has left at full width); the probes hold 4
# rows of hymba's 1.66 B and 8 rows of the cut falcon's 1.38 B
# parameters, more than the card has free beside the workers.
# phi-3-vision-4.2b (4.15 B with f32 AdamW state does not fit either) is
# cut to 8 of its 32 layers and trains text-only, as the JAX launcher
# does; its probe may fit in one pass.  (label, argv, must_chunk)
FAMILY_TRAIN = [
    ("hymba-1.5b", ["--arch", "hymba-1.5b", "--seq-len", "32",
                    "--trainers", "1", "--workers", "2", "--inner-steps",
                    "2", "--outer-steps", "3", "--initial-batch", "2",
                    "--max-batch", "2", "--no-switch"], True),
    ("falcon-mamba-7b", ["--arch", "falcon-mamba-7b", "--num-layers", "8",
                         "--seq-len", "32", "--trainers", "1", "--workers",
                         "2", "--inner-steps", "2", "--outer-steps", "3",
                         "--initial-batch", "8", "--max-batch", "8",
                         "--no-switch"], True),
    ("phi-3-vision-4.2b", ["--arch", "phi-3-vision-4.2b", "--num-layers",
                           "8", "--seq-len", "32", "--trainers", "1",
                           "--workers", "2", "--inner-steps", "2",
                           "--outer-steps", "3", "--initial-batch", "2",
                           "--max-batch", "2", "--no-switch"], False),
]


def phase_train_families():
    """AdLoCo on the hybrid, SSM and VLM families through the launcher,
    bf16 with f32 AdamW state.  Returns the gradstats launches per
    run."""
    return {label: run_training_family(label, argv, must_chunk)
            for label, argv, must_chunk in FAMILY_TRAIN}


# (arch, prompts, prompt length, new tokens): every dense config the
# port runs beside microllama, and the MoE family; gemma3-4b's prompts
# pass its 1024-token window
FAMILY_SERVE = [("qwen3-0.6b", 4, 512, 32), ("gemma3-4b", 2, 2048, 16),
                ("stablelm-1.6b", 4, 512, 32),
                ("phi3-medium-14b", 2, 512, 16),
                ("deepseek-moe-16b", 2, 512, 16)]


def phase_generate_families():
    """``serve.generate`` on each of FAMILY_SERVE at full width in bf16,
    one model at a time, each freed before the next: flash on the
    tensor-core path once per layer, the kernel prefill within 5% of the
    plain prefill's largest logit, ids in range (``generate_main_path``).
    No server equality for MoE: capacity couples a batch's rows in the
    reference too.  Returns the launch counts per model."""
    from repro_torch.configs import get_config

    out = {}
    for arch, B, S, new in FAMILY_SERVE:
        n = get_config(arch).num_layers
        launches, held = generate_main_path(
            arch, B, S, new, {"flash_attention": n, "flash_attention_tc": n,
                              "flash_attention_fma": 0, "mamba_scan": 0})
        del held
        torch.cuda.empty_cache()
        out[arch] = launches
    return out


def phase_generate_vlm():
    """``serve.generate`` on phi-3-vision-4.2b at full width in bf16: a
    seeded 576-patch prefix before 2 prompts of 512 tokens, flash on the
    tensor-core path once per layer (``generate_main_path``)."""
    from repro_torch.configs import get_config

    n = get_config("phi-3-vision-4.2b").num_layers
    launches, held = generate_main_path(
        "phi-3-vision-4.2b", 2, 512, 32,
        {"flash_attention": n, "flash_attention_tc": n,
         "flash_attention_fma": 0, "mamba_scan": 0}, prefix=576)
    del held
    torch.cuda.empty_cache()
    return launches


def encdec_inputs(cfg, B: int, S: int, dtype):
    """Seeded frames (B, F, d) in ``dtype`` and prompts (B, S) on the
    card."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    frames = torch.randn((B, cfg.num_prefix_tokens, cfg.d_model),
                         generator=gen, device="cuda").to(dtype)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device="cuda")
    return frames, prompts


def rel_gap(got, want, rel_tol: float):
    """(max abs difference, tol = rel_tol * want's largest magnitude)."""
    return ((got.float() - want.float()).abs().max().item(),
            rel_tol * want.float().abs().max().item())


@torch.inference_mode()
def encdec_f32_tokens(new: int):
    """whisper-small in f32: greedy tokens of ``generate`` with the
    flash kernel (FMA path) against the plain encoder, row by row; a
    divergence is excused only where the plain logits' top-2 gap at the
    first divergent position is below 1e-3."""
    from repro_torch import models, serve
    from repro_torch.configs import get_config
    from repro_torch.models import encdec

    cfg = get_config("whisper-small").with_overrides(dtype="float32")
    params = models.init_params(cfg, 0)
    frames, prompts = encdec_inputs(cfg, 4, 4, torch.float32)
    reset_counts()
    got = serve.generate(params, cfg, prompts, max_new_tokens=new,
                         frames=frames).tokens
    launches = launch_counts()
    with only_kernel(None):
        want = serve.generate(params, cfg, prompts, max_new_tokens=new,
                              frames=frames).tokens
    enc = encdec.encode(params, frames, cfg)
    excused = []
    for b, (g, w) in enumerate(zip(got, want)):
        i = _first_divergence(g, w)
        if i is None:
            continue
        seq = torch.cat([prompts[b], torch.tensor(w[:i], device="cuda")])
        logits = encdec.decode_forward(params, seq[None], enc[b:b + 1], cfg)
        top2 = torch.topk(logits[0, -1].float(), 2).values
        row = dict(row=b, position=i, top2_gap=(top2[0] - top2[1]).item())
        if row["top2_gap"] >= 1e-3:
            raise AssertionError(f"whisper-small f32: kernel and plain "
                                 f"greedy tokens diverge away from a "
                                 f"near-tie: {row}")
        excused.append(row)
    if launches["flash_attention_fma"] != cfg.encoder_layers \
            or launches["flash_attention_tc"]:
        raise AssertionError(f"whisper-small f32: flash must run the FMA "
                             f"path once per encoder layer: {launches}")
    del params
    torch.cuda.empty_cache()
    return dict(launches=launches, tokens_equal=got == want,
                excused_near_ties=excused)


@torch.inference_mode()
def phase_generate_encdec():
    """``serve.generate`` on whisper-small at full width in bf16 (seeded
    random weights and frames): the encoder runs once (flash on the
    tensor-core path once per encoder layer, counted from 0 just before
    the call), the 4-token prompts are teacher-forced, then 32 greedy
    tokens.  Kernel and plain encoder states, and the first logits,
    within 5% of their largest magnitude; then the f32 token check
    (``encdec_f32_tokens``).  Returns the launch counts."""
    from repro_torch import models, serve
    from repro_torch.configs import get_config
    from repro_torch.models import encdec

    B, S, new = 4, 4, 32
    cfg = get_config("whisper-small")                       # bf16
    t0 = time.perf_counter()
    params = models.init_params(cfg, 0)
    frames, prompts = encdec_inputs(cfg, B, S, params.embed.dtype)
    serve.generate(params, cfg, prompts, max_new_tokens=2, frames=frames)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = serve.generate(params, cfg, prompts, max_new_tokens=new,
                         frames=frames)
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_ids(res, cfg, B, new)
    n = cfg.encoder_layers
    expect = {"flash_attention": n, "flash_attention_tc": n,
              "flash_attention_fma": 0, "mamba_scan": 0}

    # bf16: kernel and plain encoders differ in where they round (the
    # plain softmax's probabilities go to bf16 before the PV product)
    enc_k = encdec.encode(params, frames, cfg, use_kernels=True)
    enc_p = encdec.encode(params, frames, cfg, use_kernels=False)

    def first_logits(use_kernels):
        cache = encdec.init_cache(cfg, params, frames, S + 1,
                                  use_kernels=use_kernels)
        for t in range(S):
            logits, cache = encdec.decode_step(params, cache, prompts[:, t],
                                               t, cfg)
        return logits

    lk, lp = first_logits(True), first_logits(False)
    enc_err, enc_tol = rel_gap(enc_k, enc_p, 5e-2)
    log_err, log_tol = rel_gap(lk, lp, 5e-2)
    f32 = encdec_f32_tokens(new)
    emit("generate_encdec", arch=cfg.name, dtype=cfg.dtype,
         encoder_layers=n, decoder_layers=cfg.num_layers,
         d_model=cfg.d_model,
         params=sum(p.numel() for p in params.parameters()), batch=B,
         frames=cfg.num_prefix_tokens, prompt=S, new_tokens=new,
         setup_s=setup_s, launches=launches, expected_launches=expect,
         **gen_times(res, wall_s, B, cfg.num_prefix_tokens + S, new),
         max_memory_allocated=peak, encoder_max_abs_err=enc_err, encoder_tol=enc_tol,
         first_logits_max_abs_err=log_err, first_logits_tol=log_tol,
         logits_finite=bool(torch.isfinite(lk).all()),
         greedy_first_token_agrees=int(
             (lk.argmax(-1) == lp.argmax(-1)).sum()),
         f32=f32, first_tokens=[r[:8] for r in res.tokens])
    faults = []
    if {k: launches[k] for k in expect} != expect:
        faults.append(f"generate launched {launches}, expected {expect}")
    if not row_ok(enc_err, enc_tol) or not row_ok(log_err, log_tol) \
            or not torch.isfinite(lk).all():
        faults.append(f"kernel and plain differ: encoder {enc_err} (tol "
                      f"{enc_tol}), first logits {log_err} (tol {log_tol})")
    if faults:
        raise AssertionError(f"{cfg.name}: {faults}")
    del params, enc_k, enc_p
    torch.cuda.empty_cache()
    return launches


def row_ok(err: float, tol: float) -> bool:
    return math.isfinite(err) and err <= tol


def inner_steps(label: str, cfg, batches):
    """AdamW inner steps (``core.diloco.make_inner_step`` over
    ``models.loss_fn``, no accumulation) on ``cfg`` at its width in
    bf16 with f32 AdamW state, one per batch, with the launch counts
    set to 0 just before and read just after.  Fails unless every loss
    is finite, the parameters moved and stayed finite, and no kernel
    launched (training runs attention on the plain path)."""
    from repro_torch import models, optim
    from repro_torch.core.diloco import make_inner_step
    from repro_torch.models import lm

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    params = lm.param_dict(models.init_params(cfg, 0))
    first = {k: v.clone() for k, v in params.items()}
    opt = optim.adamw(3e-4)
    state = opt.init(params)
    step = make_inner_step(lambda p, b: models.loss_fn(p, b, cfg), opt, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, device_ms = [], []
    t0 = time.perf_counter()
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, loss, _ = step(params, state, batch)
        end.record()
        end.synchronize()
        losses.append(float(loss))
        device_ms.append(start.elapsed_time(end))
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    moved = max((params[k].float() - first[k].float()).abs().max().item()
                for k in params)
    finite = all(bool(torch.isfinite(v.float()).all())
                 for v in params.values())
    batch = batches[0]
    emit("train_inner", run=label, arch=cfg.name, dtype=cfg.dtype,
         layers=cfg.num_layers,
         params=sum(v.numel() for v in params.values()),
         batch_shapes={k: list(v.shape) for k, v in batch.items()},
         losses=losses, step_ms=device_ms, wall_s=wall,
         max_memory_allocated=peak, max_param_change=moved,
         final_params_finite=finite, launches=launches)
    if not all(math.isfinite(x) for x in losses) or not finite \
            or not moved > 0:
        raise AssertionError(f"{label}: losses {losses}, params finite "
                             f"{finite}, moved {moved}")
    # the forward-only kernels: flash's serving call and the scan (the
    # flash training route counts apart, as flash_train_*)
    if any(n for k, n in launches.items() if not k.startswith("flash_train")):
        raise AssertionError(f"{label}: training launched a forward-only "
                             f"kernel: {launches}")
    del params, first, state
    torch.cuda.empty_cache()
    return dict(losses=losses, step_ms=device_ms, peak=peak)


def phase_train_encdec_vlm():
    """whisper-small at full width: 3 inner steps on 4 x (1500 seeded
    frames, 128 tokens); phi-3-vision-4.2b cut to 8 layers (as in
    ``FAMILY_TRAIN``): one inner step on 2 x (576-patch prefix, 128
    tokens)."""
    from repro_torch.configs import get_config

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(3)
    cfg = get_config("whisper-small")
    batches = [{"frames": torch.randn(
                    (1, 4, cfg.num_prefix_tokens, cfg.d_model),
                    generator=gen, device="cuda").to(torch.bfloat16),
                "tokens": torch.randint(0, cfg.vocab_size, (1, 4, 128),
                                        generator=gen, device="cuda")}
               for _ in range(3)]
    out["whisper-small"] = inner_steps("whisper-small", cfg, batches)
    cfg = get_config("phi-3-vision-4.2b").with_overrides(num_layers=8)
    batches = [{"prefix_emb": torch.randn(
                    (1, 2, cfg.num_prefix_tokens, cfg.d_model),
                    generator=gen, device="cuda").to(torch.bfloat16),
                "tokens": torch.randint(0, cfg.vocab_size, (1, 2, 128),
                                        generator=gen, device="cuda")}]
    out["phi-3-vision-4.2b@8"] = inner_steps("phi-3-vision-4.2b_prefix",
                                             cfg, batches)
    return out


# the links between pods in the async cluster run: one 400 Gb/s NDR
# InfiniBand NIC per node (NVIDIA ConnectX-7), in bytes/s, and a few us
# per hop through its switch (a choice of this script)
IB_NDR_BW = 400e9 / 8
IB_NDR_LATENCY = 5e-6


def cluster_inputs(spares: int, argv=TRAIN_ARGV):
    """Model, loss, config and fresh seeded inputs on the card of
    ``launch.train``'s settings (``argv``), with ``spares`` spare data
    shards."""
    from repro_torch import models
    from repro_torch.data import make_shard_streams
    from repro_torch.launch import train
    from repro_torch.models import lm

    args = train.parse_args(argv)
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


def cluster_run(label: str, *, spares: int = 0, acfg_kw=None,
                argv=TRAIN_ARGV, **kw):
    """One ``run_cluster`` on the card with the gradstats counts set to 0
    just before it and read just after, its stats reductions counted and
    the first one also computed by the plain version; prints the run's
    line and checks the run."""
    from repro_torch.cluster import run_cluster
    from repro_torch.kernels.gradstats import ops as gs_ops

    cfg, acfg, loss_fn, inits, streams = cluster_inputs(spares, argv)
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


# phase_cluster's training settings on one trainer of two workers, one
# per process, with the batch statistics composed across the processes
CLUSTER_MP_ARGV = TRAIN_ARGV + ["--trainers", "1", "--no-merge",
                                "--stats-estimator", "microbatch"]
# one trainer of one worker: the one-process backend run (per-sample
# probe through the gradstats kernels)
ONE_PROC_ARGV = TRAIN_ARGV + ["--trainers", "1", "--workers", "1",
                              "--no-merge"]
MP_WORKER = "--cluster-mp-worker"
MP_LABEL = "gloo over loopback, two processes on one card"


def card_settings() -> None:
    """Full-f32 products (no TF32) for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def cluster_mp_worker(argv) -> int:
    """One rank of ``phase_cluster_mp``'s two-process run (``chip_smoke.py
    --cluster-mp-worker RANK PROCS INIT_METHOD POLICY OUT_DIR``):
    ``run_cluster`` with a ``TorchProcessBackend`` on ``cuda:0``; every
    rank writes its line to OUT_DIR, rank 0 also the run and the final
    params."""
    import torch.distributed as dist

    from repro_torch.cluster import (NetworkModel, Trace,
                                     TorchProcessBackend,
                                     make_heterogeneous_profiles,
                                     run_cluster)
    from repro_torch.cluster.launch_mp import allgather_rows, init_group

    rank, procs, init_method, policy, out = argv
    rank, procs, out = int(rank), int(procs), Path(out)
    card_settings()
    init_group(init_method, rank, procs, timeout=600.0)
    cfg, acfg, loss_fn, inits, streams = cluster_inputs(0, CLUSTER_MP_ARGV)
    backend = TorchProcessBackend(NetworkModel(), device="cuda")
    inits = [backend.broadcast_params(p) for p in inits]
    trace = Trace() if policy == "async" else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pool, hist, rep = run_cluster(
        loss_fn, inits, streams, acfg, policy=policy,
        profiles=make_heterogeneous_profiles(procs, ratio=2.0),
        backend=backend, trace=trace, eval_fn=param_checksum,
        device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # every rank must hold the same trajectory and params
    rows = allgather_rows(hist.eval_loss + [b[0] for b
                                            in hist.requested_batches])
    if not (rows == rows[0]).all():
        raise AssertionError(f"ranks diverged: {rows.tolist()}")
    line = {"rank": rank, "wall_s": wall,
            "round_wall_ms": [w * 1e3 for w in rep.round_wall_s],
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
    if rank == 0:
        line.update(
            batches=hist.requested_batches, modes=hist.modes,
            sim_time=rep.sim_time, num_syncs=rep.num_syncs,
            num_stats_syncs=rep.num_stats_syncs,
            checksums=hist.eval_loss, losses=hist.loss,
            real_comm_time=rep.real_comm_time)
        if trace is not None:
            kinds = {}
            for sp in trace.real_spans():
                kinds[sp.kind] = kinds.get(sp.kind, 0) + 1
            line.update(sim_digest=trace.sim_digest(),
                        real_overlap_frac=trace.overlap_fraction(
                            clock="real"),
                        real_span_kinds=kinds)
        torch.save({k: v.cpu() for k, v in pool.global_params.items()},
                   out / "params.pt")
    (out / f"rank{rank}.json").write_text(json.dumps(line))
    dist.destroy_process_group()
    return 0


def run_cluster_mp(policy: str, procs: int = 2) -> dict:
    """Spawn ``procs`` fresh interpreters running ``cluster_mp_worker``
    (every one on the one card), wait for them, and return rank 0's line
    with every rank's peak memory and wall time and the final params."""
    import tempfile

    from repro_torch.cluster.launch_mp import child_env, free_port, spawn

    init = f"tcp://127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory() as tmp:
        cmds = [[sys.executable, str(ROOT / "chip_smoke.py"), MP_WORKER,
                 str(r), str(procs), init, policy, tmp]
                for r in range(procs)]
        t0 = time.perf_counter()
        spawn(cmds, timeout=600.0, env=child_env())
        res = json.loads((Path(tmp) / "rank0.json").read_text())
        res["spawn_wall_s"] = time.perf_counter() - t0
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(procs)]
        res["max_memory_allocated"] = [r["max_memory_allocated"]
                                       for r in ranks]
        res["rank_wall_s"] = [r["wall_s"] for r in ranks]
        res["params"] = torch.load(Path(tmp) / "params.pt")
    return res


EXAMPLES = [("quickstart", []), ("adloco_vs_diloco", []),
            ("train_100m", ["--demo"]), ("heterogeneous_cluster", []),
            ("serve_batched", []), ("continuous_batching", [])]


def run_examples() -> dict:
    """Each example's ``main`` on the card in a fresh interpreter, which
    must exit 0; returns each one's wall seconds and its flash and scan
    launches."""
    code = ("import json, sys, time\n"
            "from importlib import import_module\n"
            "from repro_torch.kernels.flash_attention import ops\n"
            "from repro_torch.kernels.mamba_scan import ops as scan\n"
            "ex = import_module('repro_torch.examples.' + sys.argv[1])\n"
            "t0 = time.perf_counter()\n"
            "ex.main(sys.argv[2:])\n"
            "print(json.dumps({'wall_s': time.perf_counter() - t0,"
            " 'flash': ops.launches, 'flash_tc': ops.tc_launches,"
            " 'flash_fma': ops.fma_launches, 'scan': scan.scan_launches}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = {}
    for name, argv in EXAMPLES:
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", code, name, *argv],
                             capture_output=True, text=True, env=env,
                             cwd=ROOT, timeout=600)
        if run.returncode != 0:
            raise AssertionError(f"example {name} exited {run.returncode}:"
                                 f"\n{run.stdout[-2000:]}"
                                 f"\n{run.stderr[-3000:]}")
        res = json.loads(run.stdout.strip().splitlines()[-1])
        res["process_wall_s"] = time.perf_counter() - t0
        emit("example", name=name, argv=argv, **res,
             last_lines=run.stdout.strip().splitlines()[-4:-1])
        out[name] = res
    return out


def phase_cluster_mp():
    """``TorchProcessBackend`` on the card: two processes (one worker of
    microllama-300m each, ``cuda:0`` both) against ``SimBackend`` in this
    process, sync and then async (traced); one process against
    ``SimBackend`` with the gradstats counts read; then every example.
    Returns the gradstats launches of the one-process run and the
    serving examples' flash launches."""
    from repro_torch.cluster import (NetworkModel, Trace,
                                     TorchProcessBackend,
                                     make_heterogeneous_profiles)

    card_settings()                  # as the workers: no TF32

    def equal_params(a, b):
        return all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a)

    # 1. sync: the two-process run against SimBackend on the same inputs
    profiles = make_heterogeneous_profiles(2, ratio=2.0)
    pool, hist, rep, _ = cluster_run(
        "mp_reference_sync", argv=CLUSTER_MP_ARGV, policy="sync",
        profiles=profiles, network=NetworkModel())
    ref = {"batches": hist.requested_batches, "modes": hist.modes,
           "sim_time": rep.sim_time, "checksums": hist.eval_loss}
    ref_params = {k: v.cpu() for k, v in pool.global_params.items()}
    del pool, hist
    torch.cuda.empty_cache()
    mp = run_cluster_mp("sync")
    bitwise = equal_params(mp.pop("params"), ref_params)
    same = {key: mp[key] == want for key, want in ref.items()}
    emit("cluster_mp", run="sync", label=MP_LABEL, **mp,
         wall_ms_per_round=[mp["wall_s"] * 1e3 / len(mp["checksums"])],
         reference=ref, equal=same, final_params_bitwise=bitwise)
    if not all(same.values()) or not bitwise:
        raise AssertionError("the two-process sync run and SimBackend "
                             f"disagree: {same}, bitwise={bitwise}")
    del ref_params

    # 2. async, traced: the sim spans' digest as SimBackend's; one
    # in-flight window per dispatch, no standalone stats span
    trace = Trace()
    _, _, rep, _ = cluster_run(
        "mp_reference_async", argv=CLUSTER_MP_ARGV, policy="async",
        profiles=profiles, network=NetworkModel(), trace=trace)
    torch.cuda.empty_cache()
    mp = run_cluster_mp("async")
    mp.pop("params")
    kinds = mp["real_span_kinds"]
    census = (kinds.get("outer", 0) + kinds.get("piggyback", 0)
              == mp["num_syncs"]
              and kinds.get("piggyback", 0) == mp["num_stats_syncs"] > 0
              and kinds.get("stats", 0) == 0)
    checks = {"sim_digest": mp["sim_digest"] == trace.sim_digest(),
              "real_overlap": mp["real_overlap_frac"] > 0.0,
              "census": census}
    emit("cluster_mp", run="async", label=MP_LABEL, **mp,
         reference_sim_digest=trace.sim_digest(), checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"the two-process async run failed: {checks}")
    del trace, rep

    # 3. one process: the backend's identity collectives through the f32
    # wire buffer, bitwise equal to SimBackend; the gradstats kernels
    # launch once per stats reduction (cluster_run's counts)
    profiles = make_heterogeneous_profiles(1, ratio=2.0)
    pool, _, _, _ = cluster_run(
        "one_process_sim", argv=ONE_PROC_ARGV, policy="sync",
        profiles=profiles, network=NetworkModel())
    ref_params = {k: v.cpu() for k, v in pool.global_params.items()}
    del pool
    pool, _, rep, launches = cluster_run(
        "one_process_torch", argv=ONE_PROC_ARGV, policy="sync",
        profiles=profiles,
        backend=TorchProcessBackend(NetworkModel(), device="cuda"))
    bitwise = equal_params(pool.global_params, ref_params)
    emit("cluster_mp", run="one_process", launches=launches,
         real_comm_time=rep.real_comm_time, final_params_bitwise=bitwise)
    if not bitwise or not rep.real_comm_time > 0.0:
        raise AssertionError("the one-process TorchProcessBackend run and "
                             "SimBackend disagree")
    del pool, ref_params
    torch.cuda.empty_cache()

    # 4. the examples
    examples = run_examples()
    return launches, {name: {k: examples[name][k] for k in
                             ("flash", "flash_tc", "flash_fma", "scan")}
                      for name in ("serve_batched", "continuous_batching")}


# ----------------------------------------------------------------------
# 12. the analysis layer: dry run on the production mesh, count vs card
# ----------------------------------------------------------------------

# (arch, shape) of the dry runs: MicroLlama-300M's four shapes, two FSDP
# combos (more than 5e9 parameters), qwen3-0.6b's training step,
# falcon-mamba-7b's batch-1 decode (laid out on each card's shards), the
# prefills that trace a trip-scaled scan (ssm, hybrid) or write a sharded
# self-attention cache (encoder-decoder), and one combo of each kind that
# torch 2.11 refused before PR 21 (decode attention over a cache split
# along C, the shared experts' products, an uneven head merge, the hybrid
# decode's partial sums), which must all record "ok"
PREFILL_COMBOS = [("falcon-mamba-7b", "prefill_32k"),
                  ("hymba-1.5b", "prefill_32k"),
                  ("whisper-small", "prefill_32k")]
REFUSED_COMBOS = [("qwen3-0.6b", "decode_32k"),
                  ("deepseek-moe-16b", "prefill_32k"),
                  ("whisper-small", "train_4k"),
                  ("hymba-1.5b", "long_500k")]
# programs whose local layers attend in blocks (``layers.sdpa_banded``):
# gemma3-4b's heads split over the model axis, hymba-1.5b's query rows
# (its prefill_32k is in PREFILL_COMBOS)
BANDED_COMBOS = [("gemma3-4b", "prefill_32k"), ("gemma3-4b", "train_4k")]
DRYRUN_COMBOS = [("microllama-300m", s) for s in
                 ("train_4k", "prefill_32k", "decode_32k", "long_500k")] \
    + [("phi3-medium-14b", "train_4k"), ("grok-1-314b", "train_4k"),
       ("qwen3-0.6b", "train_4k"), ("falcon-mamba-7b", "long_500k")] \
    + BANDED_COMBOS + PREFILL_COMBOS + REFUSED_COMBOS
# the baseline's dry runs (REPRO_BASELINE=1, written to their own
# directory), each printed beside the policy's count of the same combo
# where phase 12 traces it; the two MoE train steps run the dispatch
# that torch 2.11 once refused without its constraints
BASELINE_COMBOS = [("microllama-300m", "train_4k"),
                   ("microllama-300m", "prefill_32k"),
                   ("falcon-mamba-7b", "prefill_32k"),
                   ("whisper-small", "prefill_32k"),
                   ("grok-1-314b", "train_4k"),
                   ("deepseek-moe-16b", "train_4k")]
# per-card train_4k FLOPs that the CPU dry run counts on torch 2.13
# (`python -m repro_torch.launch.dryrun --all`, PERF.md section 5); the
# card's torch must count the same: with the gradients constrained like
# their activations and each layer recomputed in the backward (the
# losses' remat), the unsharded step's count over 256, grok-1-314b's
# plus its replicated router's product on every model card
TRAIN_FLOPS_TORCH_2_13 = {"microllama-300m": 11370729308160.0,
                          "qwen3-0.6b": 32925359538176.0,
                          "phi3-medium-14b": 484211530137600.0,
                          "grok-1-314b": 3476934403031040.0}
# per-card FLOPs of the former refusals, the banded programs and the
# baseline combos on the CPU's torch 2.13 (the same sweeps, the second with
# REPRO_BASELINE=1), which the card's torch must count too
FLOPS_TORCH_2_13 = {
    **{(arch, "train_4k"): f for arch, f in TRAIN_FLOPS_TORCH_2_13.items()},
    ("qwen3-0.6b", "decode_32k"): 4354080768.0,
    ("deepseek-moe-16b", "prefill_32k"): 53725798334464.0,
    ("whisper-small", "train_4k"): 8557633732608.0,
    ("hymba-1.5b", "long_500k"): 44416400.0,
    ("falcon-mamba-7b", "long_500k"): 126337024.0,
    # the banded local layers: gemma3-4b's prefill is JAX's count
    # (3.3776e13), its train step and hymba's prefill below JAX's
    ("gemma3-4b", "prefill_32k"): 33775790587904.0,
    ("gemma3-4b", "train_4k"): 130416950378496.0,
    ("hymba-1.5b", "prefill_32k"): 16099429274000.0}
# the baseline's train steps count the policy's FLOPs, its prefills the
# policy's plus the head over every position (whisper-small's prefill
# has no more logits than the policy's)
BASELINE_FLOPS_TORCH_2_13 = {
    ("microllama-300m", "train_4k"): 11370729308160.0,
    ("microllama-300m", "prefill_32k"): 8824010309632.0,
    ("falcon-mamba-7b", "prefill_32k"): 57363583205376.0,
    ("whisper-small", "prefill_32k"): 47795581632.0,
    ("grok-1-314b", "train_4k"): 3476934403031040.0,
    ("deepseek-moe-16b", "train_4k"): 111642121601024.0}


def dryrun_combo(arch: str, shape: str, out: Path,
                 baseline: bool = False) -> dict:
    """``python -m repro_torch.launch.dryrun`` for one combo in a fresh
    interpreter (its fake process group of 256 ranks lives and dies
    there; ``baseline``: with ``REPRO_BASELINE=1``) -> its artifact
    (``ok`` or ``error``: one is written even when the run exits 1), or
    the skip it printed."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("REPRO_BASELINE", None)
    if baseline:
        env["REPRO_BASELINE"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", str(out)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=900)
    art = out / f"{arch}__{shape}__h100_32x8.json"
    if proc.returncode == 0 and not art.exists():      # a skip saves nothing
        return {"arch": arch, "shape": shape, "status": "skipped",
                "torch": torch.__version__, "baseline": baseline}
    if not art.exists():
        raise AssertionError(f"dry run {arch} {shape} failed "
                             f"(exit {proc.returncode}): {proc.stdout[-1500:]}"
                             f"{proc.stderr[-1500:]}")
    return json.loads(art.read_text())


def card_check(label: str, cfg, shape, make_args, iters: int = 5,
               warmup: int = 2) -> dict:
    """The dry run's program for ``shape`` on the (1, 1) host mesh: its
    count on meta tensors (a sequential scan's blocks traced once and
    scaled by their trip count), then on the card with real tensors
    (every block run): FLOPs and bytes equal; the predicted peak against
    the allocator's; the device time against the roofline bound of the
    card's count.

    A training step on the card sends its attention to flash's training
    route, whose ctypes launches the dispatch counter does not see,
    while the meta trace counts the plain attention (as JAX's lowering
    does).  There the check requires every training attention call on
    the route and the card's count below the meta count in both FLOPs
    and bytes, and prints the gap: the dry run's training numbers are
    the plain program's, not the card's (ROADMAP, open items)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import dryrun, op_analysis
    from repro_torch.launch import mesh as M
    mesh = M.make_host_mesh()
    step, meta_args, policy = dryrun.build_program(cfg, shape, mesh)
    meta = op_analysis.OpCounter()
    dryrun.trace(meta, step, meta_args, policy)
    predicted = dryrun.local_bytes(meta_args) + meta.temp_bytes
    args = make_args()
    card = op_analysis.OpCounter()
    flash_ops.reset_train_counts()
    dryrun.trace(card, step, args, policy)
    route = {"fwd": flash_ops.train_fwd_launches,
             "bwd": flash_ops.train_bwd_launches,
             "plain": flash_ops.train_plain_calls}
    if route["fwd"] == 0:
        if (card.cost.flops, card.cost.bytes) != (meta.cost.flops,
                                                  meta.cost.bytes):
            raise AssertionError(
                f"{label}: card count {card.cost.flops} FLOPs, "
                f"{card.cost.bytes} bytes != meta count {meta.cost.flops}, "
                f"{meta.cost.bytes}")
    elif (route["plain"] or not route["fwd"] >= route["bwd"] > 0
          or card.cost.flops >= meta.cost.flops
          or card.cost.bytes >= meta.cost.bytes):
        raise AssertionError(
            f"{label}: training route {route}, card count "
            f"{card.cost.flops} FLOPs, {card.cost.bytes} bytes against the "
            f"plain program's meta count {meta.cost.flops}, "
            f"{meta.cost.bytes}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ms = device_ms(lambda: step(*args), iters=iters, warmup=warmup)
    compute_ms = card.cost.flops / PEAK_BF16 * 1e3
    memory_ms = card.cost.bytes / PEAK_BYTES * 1e3
    bound_ms = max(compute_ms, memory_ms)
    row = {"check": label, "shape": [shape.global_batch, shape.seq_len],
           "torch": torch.__version__,
           "flops_meta": meta.cost.flops, "flops_card": card.cost.flops,
           "bytes_card": card.cost.bytes, "bytes_meta": meta.cost.bytes,
           "flash_train_route": route,
           "predicted_peak_bytes": predicted, "max_memory_allocated": peak,
           "device_ms": ms, "compute_ms": compute_ms, "memory_ms": memory_ms,
           "bound_ms": bound_ms,
           "bound_by": "operations" if compute_ms >= memory_ms else "bytes",
           "bound_over_measured": bound_ms / ms}
    emit("analysis_card", **row)
    if bound_ms > ms:
        raise AssertionError(f"{label}: bound {bound_ms} ms above the "
                             f"measured {ms} ms: the count is too high")
    return row


def phase_analysis() -> dict:
    """Phase 12: the dry run of ``DRYRUN_COMBOS`` and ``BASELINE_COMBOS``
    on h100_32x8 (each in its own interpreter, eight at a time) and
    their roofline rows; then the count held against the card."""
    import torch.distributed as dist

    from repro_torch import models
    from repro_torch.cluster.launch_mp import free_port
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import roofline
    out = ROOT / "build" / "chip_smoke_dryrun"
    out_base = ROOT / "build" / "chip_smoke_dryrun_baseline"
    for d in (out, out_base):
        d.mkdir(parents=True, exist_ok=True)
        for old in d.glob("*.json"):
            old.unlink()
    runs = [(c, out, False) for c in DRYRUN_COMBOS] \
        + [(c, out_base, True) for c in BASELINE_COMBOS]
    # eight interpreters at a time, one per host core, the card's cache
    # of the earlier phases handed back first
    gc.collect()
    torch.cuda.empty_cache()
    with ThreadPoolExecutor(min(len(runs), 8)) as pool:
        done = list(pool.map(lambda r: dryrun_combo(*r[0], r[1], r[2]),
                             runs))
    results, baselines = done[:len(DRYRUN_COMBOS)], done[len(DRYRUN_COMBOS):]
    for r in results:
        if r["status"] == "ok":
            emit("analysis_dryrun", arch=r["arch"], shape=r["shape"],
                 mesh=r["mesh"], status="ok", torch=r["torch"],
                 flops=r["flops"],
                 bytes=r["bytes_accessed"],
                 wire_bytes=r["collective_wire_bytes"],
                 per_collective=r["per_collective"],
                 argument_bytes=r["memory"]["argument_bytes"],
                 temp_bytes=r["memory"]["temp_bytes"],
                 trace_s=r["compile_s"])
        else:
            emit("analysis_dryrun", arch=r["arch"], shape=r["shape"],
                 status=r["status"], torch=r["torch"], op=r.get("op"),
                 reason=r.get("reason", r.get("error", ""))[:300])
    rows = roofline.load_rows(str(out))
    for r in rows:
        emit("analysis_roofline", arch=r.arch, shape=r.shape, mesh=r.mesh,
             torch=r.torch,
             compute_s=r.compute_s, memory_s=r.memory_s,
             collective_s=r.collective_s, bound_s=r.bound_s,
             dominant=r.dominant, useful_ratio=r.useful_ratio,
             roofline_fraction=r.roofline_fraction)
    if len(rows) != sum(r["status"] == "ok" for r in results):
        raise AssertionError("roofline rows do not match the dry runs")
    failed = [(r["arch"], r["shape"], r["op"]) for r in results
              if r["status"] == "error"]
    if failed:
        raise AssertionError(f"dry runs failed on torch {torch.__version__}:"
                             f" {failed}")
    not_ok = [(r["arch"], r["shape"], r["status"]) for r in results
              if (r["arch"], r["shape"]) in PREFILL_COMBOS + REFUSED_COMBOS
              and r["status"] != "ok"]
    if not_ok:
        raise AssertionError(f"dry runs not traced: {not_ok}")
    differ = []
    for r in results:
        ref = FLOPS_TORCH_2_13.get((r["arch"], r["shape"]))
        if ref is None:
            continue
        emit("analysis_versions", arch=r["arch"], shape=r["shape"],
             torch=r["torch"], flops=r["flops"], flops_torch_2_13=ref,
             equal=r["flops"] == ref)
        if r["flops"] != ref:
            differ.append((r["arch"], r["shape"], r["flops"], ref))
    policy = {(r["arch"], r["shape"]): r for r in results}
    for r in baselines:
        key = (r["arch"], r["shape"])
        ref = BASELINE_FLOPS_TORCH_2_13[key]
        emit("analysis_baseline", arch=r["arch"], shape=r["shape"],
             status=r["status"], torch=r["torch"],
             baseline=r.get("baseline"), flops=r.get("flops"),
             flops_torch_2_13=ref,
             policy_flops=policy.get(key, {}).get("flops"),
             bytes=r.get("bytes_accessed"),
             policy_bytes=policy.get(key, {}).get("bytes_accessed"),
             wire_bytes=r.get("collective_wire_bytes"),
             op=r.get("op"))
        if r["status"] != "ok" or r.get("baseline") is not True:
            raise AssertionError(f"baseline dry run {key} not traced as the "
                                 f"baseline: {r['status']} {r.get('op')}")
        if r["flops"] != ref:
            differ.append((r["arch"], r["shape"], "baseline", r["flops"],
                           ref))
    if differ:
        raise AssertionError(f"FLOPs per card on torch {torch.__version__} "
                             f"differ from torch 2.13's: {differ}")

    cfg = get_config("microllama-300m")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        params = models.lm.param_dict(models.init_params(cfg, 0))
        gen = torch.Generator(device="cuda").manual_seed(0)

        def tokens(*shape):
            return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                 device="cuda", dtype=torch.int32)

        prefill = InputShape("card_prefill", 512, 4, "prefill")
        checks = [card_check("prefill_4x512", cfg, prefill,
                             lambda: (params, {"tokens": tokens(4, 512)}))]
        from repro_torch import optim
        train = InputShape("card_train", 128, 8, "train")
        opt_state = optim.adamw(2e-5, weight_decay=0.1).init(params)
        checks.append(card_check(
            "train_step_8x128", cfg, train,
            lambda: (params, opt_state, {"tokens": tokens(1, 8, 128)})))
        del params, opt_state
        # falcon-mamba-7b's plain prefill: the sequential scan's 32
        # blocks of 16 steps per layer, traced once on meta tensors
        fcfg = get_config("falcon-mamba-7b")
        fparams = models.lm.param_dict(models.init_params(fcfg, 0))
        ftokens = torch.randint(0, fcfg.vocab_size, (4, 512), generator=gen,
                                device="cuda", dtype=torch.int32)
        checks.append(card_check("falcon_prefill_4x512", fcfg, prefill,
                                 lambda: (fparams, {"tokens": ftokens}),
                                 iters=3, warmup=1))
        del fparams
    finally:
        dist.destroy_process_group()
    return {"dryrun": results, "baseline": baselines, "card": checks}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == [MP_WORKER]:
        return cluster_mp_worker(sys.argv[2:])
    card_settings()
    t0 = time.perf_counter()
    smi, hgmma = timed("env", phase_env)
    flash_rows = timed("kernels_flash", phase_kernels)
    flash = flash_rows[0]
    flash_train = timed("kernels_flash_train", phase_flash_train)
    gs = timed("kernels_gradstats", phase_gradstats_kernels)
    scan, scan_hybrid = timed("kernels_scan", phase_scan_kernels)
    launches = timed("generate", phase_generate)
    timed("server", phase_server)
    ssm_launches = timed("generate_ssm", phase_generate_ssm)
    hybrid_launches = timed("generate_hybrid", phase_generate_hybrid)
    timed("prefill_f32_hybrid", phase_hybrid_f32)
    timed("server_ssm", phase_server, "falcon-mamba-7b", "mamba_scan")
    train_launches = timed("train", phase_train)
    timed("train_remat", phase_remat)
    timed("banded", phase_banded)
    cluster_launches = timed("cluster", phase_cluster)
    mp_launches, example_flash = timed("cluster_mp", phase_cluster_mp)
    probe_launches = timed("probe", phase_probe)
    family_train = timed("train_families", phase_train_families)
    family_serve = timed("generate_families", phase_generate_families)
    encdec_launches = timed("generate_encdec", phase_generate_encdec)
    vlm_launches = timed("generate_vlm", phase_generate_vlm)
    timed("train_encdec_vlm", phase_train_encdec_vlm)
    timed("analysis", phase_analysis)
    new_shapes = {"whisper_encoder": [4, 1500, 12, 12, 64],
                  "phi3v_prefill": [2, 1088, 32, 32, 96]}
    new_rows = {name: next(r for r in flash_rows if r["shape"] == shape)
                for name, shape in new_shapes.items()}
    gemma = {("global" if r["window"] is None else f"window_{r['window']}"): r
             for r in flash_rows if r["shape"][4] == 256}
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
        "launches_families": {a: n["flash_attention_tc"]
                              for a, n in family_serve.items()},
        "launches_encdec": encdec_launches["flash_attention_tc"],
        "launches_vlm": vlm_launches["flash_attention_tc"],
        "launches_examples": example_flash,
        **{name: {f: r[f] for f in ("shape", "causal", "max_abs_err",
                                    "kernel_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")}
           for name, r in new_rows.items()},
        "hd256": {k: {f: r[f] for f in ("shape", "max_abs_err", "kernel_ms",
                                        "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")}
                  for k, r in gemma.items()},
        "max_abs_err": flash["max_abs_err"], "ms": flash["kernel_ms"],
        "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"], "library_ms": flash["library_ms"],
        "shape": flash["shape"], "dtype": flash["dtype"]}, {
        "name": "gradstats_colsum", "route": "cuda", "source": GRADSTATS_SRC,
        "replaces": COLSUM_TPU, "launches": train_launches["colsum"],
        "launches_cluster": {run: n["colsum"]
                             for run, n in cluster_launches.items()},
        "launches_cluster_mp": mp_launches["colsum"],
        "launches_probe_64": probe_launches["colsum"],
        "launches_train_families": {a: n["colsum"]
                                    for a, n in family_train.items()},
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
        "launches_cluster_mp": mp_launches["moments"],
        "launches_probe_64": probe_launches["moments"],
        "launches_train_families": {a: n["moments"]
                                    for a, n in family_train.items()},
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
        "hybrid_lanes": scan_hybrid["lanes"]}, {
        "name": "flash_attention_bwd", "route": "cuda", "source": FLASH_SRC,
        "replaces": None, "launches": train_launches["flash_train_bwd"],
        "launches_fwd_lse": train_launches["flash_train_fwd"],
        "by_shape": {r["arch"]: {f: r[f] for f in (
            "shape", "grads", "fwd_kernel_ms", "bwd_kernel_ms",
            "fwd_plain_ms", "bwd_plain_ms", "fwd_library_ms",
            "bwd_library_ms", "fwd_bound", "bwd_bound")}
            for r in flash_train}}]
    print(json.dumps({"kernels": kernels,
                      "seconds": time.perf_counter() - t0}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
