"""Where the main paths' time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile

This is not the counterpart of ``repro/launch/profile.py``, which
prints the dry run's top cost centres: that is ``python -m
repro_torch.launch.dryrun --arch A --shape S --profile`` here.

Serving: ``serve.generate``'s two phases at the main path's shapes
(microllama-300m, bf16, 4 prompts of 512 tokens, 32 greedy tokens) —
one prefill (flash kernel on) and the greedy decode steps; then the SSM
and hybrid serving paths at ``chip_smoke.py``'s shapes (falcon-mamba-7b,
bf16, 4 prompts of 512 tokens; hymba-1.5b, bf16, 2 prompts of 1536
tokens) — one prefill (kernels on) and one decode step each; the
encoder-decoder and the VLM at ``chip_smoke.py``'s shapes
(whisper-small, bf16, 4 x 1500 frames: the encoder and cross k/v of
``models.init_cache`` with the flash kernel on, then one decode step
after a teacher-forced 4-token prompt; phi-3-vision-4.2b, bf16, a
576-patch prefix before 2 prompts of 512 tokens: one prefill (kernels
on) and one decode step).  Training:
the phases of one AdLoCo trainer round at the training main path's
shapes (microllama-300m, bf16 with f32 AdamW state, seq 128, batch 8,
M = 2 workers) — one inner step, the per-sample gradients of a probe of
8, their gradstats reduction (kernels on), and the outer step.

Each phase runs under ``torch.profiler`` on seeded random weights: one
session per phase, whose schedule runs a warm-up call that it discards
and then records one call (a session that records from its start
loses the device records of its first kernels).  Each
prints one JSON line: host wall time, device busy
time (the union of the phase's CUDA kernel intervals), the device's idle
share of the phase's window, launches per step, and the kernels with the
most device time and the host ops with the most self CPU time.  Needs a
CUDA card; the profiler adds host time per launch, so wall times here
run above ``chip_smoke.py``'s.

A phase whose trace holds no CUDA kernel, or fewer of the port's own
kernels (flash attention, the selective scan, the two gradstats
kernels) than their wrappers' launch counters counted during the
phase, raises ``RuntimeError``: the profiler has missed device work
(it saw none at all in one run on the card), and an empty trace would
otherwise read as a 100%-idle phase.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import models, resolve_device, serve
from repro_torch.configs import get_config
from repro_torch.configs.base import AdLoCoConfig
from repro_torch.core import batching
from repro_torch.core.adloco import TrainerRound
from repro_torch.core.diloco import reshape_for_plan
from repro_torch.data import make_shard_streams
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.gradstats import ops as gradstats_ops
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.launch.train import build_loss_fn
from repro_torch.models import lm

ARCH, BATCH, PROMPT, NEW, TOP = "microllama-300m", 4, 512, 32, 8
# (arch, batch, prompt, phase-name prefix) of the SSM and hybrid paths
RECURRENT = (("falcon-mamba-7b", 4, 512, "ssm"),
             ("hymba-1.5b", 2, 1536, "hybrid"))
TRAIN_SEQ, TRAIN_BATCH, TRAIN_WORKERS = 128, 8, 2
# (arch, batch, frames, prompt) of the encoder-decoder path and (arch,
# batch, prefix, prompt) of the VLM path, as in chip_smoke.py
ENCDEC = ("whisper-small", 4, 1500, 4)
VLM = ("phi-3-vision-4.2b", 2, 576, 512)
# the port's kernels: the names their traces carry, by launch counter
TRACED_KERNELS = {"flash_attention": ("flash_tc_kernel", "flash_fwd_kernel"),
                  "mamba_scan": ("scan_kernel",),
                  "gradstats_colsum": ("colsum_kernel",),
                  "gradstats_moments": ("moments_kernel",)}


def launch_counts() -> dict:
    return {"flash_attention": flash_ops.launches,
            "mamba_scan": scan_ops.scan_launches,
            "gradstats_colsum": gradstats_ops.colsum_launches,
            "gradstats_moments": gradstats_ops.moments_launches}


# the schedule's step range, which the trace mirrors on the device
# timeline as an annotation spanning the step's kernels: not a kernel
STEP_ANNOTATION = "ProfilerStep"


def _kernel_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(STEP_ANNOTATION)]


def _busy_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def check_trace(kernels, name: str, launched: dict) -> dict:
    """The port's kernels seen in the trace, by launch counter; raises
    RuntimeError when the trace holds no kernel at all, or fewer of one
    of the port's kernels than ``launched`` (counter deltas) says ran."""
    if not kernels:
        raise RuntimeError(f"{name}: the profiler recorded no CUDA kernel; "
                           "its device time cannot be read from this trace")
    seen = {k: sum(any(m in e.name for m in marks) for e in kernels)
            for k, marks in TRACED_KERNELS.items()}
    short = {k: (seen[k], n) for k, n in launched.items() if seen[k] < n}
    if short:
        names = sorted({e.name[:60] for e in kernels})[:TOP]
        raise RuntimeError(f"{name}: the trace misses launches of the "
                           f"port's kernels (seen, counted): {short}; "
                           f"it holds {len(kernels)} kernels, e.g. {names}")
    return seen


def summarize(prof, name: str, wall_s: float, steps: int,
              launched: dict) -> dict:
    kernels = _kernel_events(prof)
    seen = check_trace(kernels, name, launched)
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    cpu = [e.time_range.start for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]
    window = max(e for _, e in spans) - min(cpu + [s for s, _ in spans])
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    host = sorted(prof.key_averages(),
                  key=lambda a: -a.self_cpu_time_total)[:TOP]
    busy = _busy_us(spans)
    return dict(
        phase=name, wall_s=wall_s, window_us=window, device_busy_us=busy,
        device_idle_share=1.0 - busy / window, kernel_launches=len(kernels),
        launches_per_step=len(kernels) / steps,
        port_kernels=dict(counted=launched, traced=seen),
        top_kernels=[dict(name=n[:90], device_us=t, calls=c,
                          share_of_busy=t / busy)
                     for n, (t, c) in ranked],
        top_host_ops=[dict(name=a.key, self_cpu_us=a.self_cpu_time_total,
                           calls=a.count) for a in host])


@torch.inference_mode()
def run():
    dev = resolve_device()
    cfg = get_config(ARCH)
    params = models.init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=gen, device=dev)
    serve.generate(params, cfg, prompts[:, :64], max_new_tokens=2)  # warm-up

    row, (logits, cache) = _profiled("prefill", lambda: models.prefill(
        params, prompts, cfg, PROMPT + NEW, use_kernels=True,
        last_only=True))
    yield row

    def decode():
        tok = torch.argmax(logits[:, -1], dim=-1)
        for i in range(NEW - 1):
            out_i, _ = models.decode_step(params, cache, tok, PROMPT + i,
                                          cfg)
            tok = torch.argmax(out_i, dim=-1)

    yield _profiled("decode", decode, NEW - 1)[0]


@torch.inference_mode()
def run_recurrent(arch: str, batch: int, prompt: int, name: str):
    """``arch`` at full width, bf16: one prefill (batch x prompt, the
    kernels on) and one greedy decode step, each after a warm-up."""
    dev = resolve_device()
    cfg = get_config(arch)
    params = models.init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            generator=gen, device=dev)

    def prefill():
        return models.prefill(params, prompts, cfg, prompt + NEW,
                              use_kernels=True, last_only=True)

    row, (logits, cache) = _profiled(f"{name}_prefill", prefill)
    yield row
    tok = torch.argmax(logits[:, -1], dim=-1)
    step = iter(range(prompt, prompt + NEW))

    def decode():
        out, _ = models.decode_step(params, cache, tok, next(step), cfg)
        return torch.argmax(out, dim=-1)

    yield _profiled(f"{name}_decode_step", decode)[0]
    del params, cache
    torch.cuda.empty_cache()


@torch.inference_mode()
def run_encdec():
    """whisper-small at full width, bf16: the encoder and cross k/v
    (``models.init_cache``, flash on), then one decode step after the
    prompt is teacher-forced; each after a warm-up."""
    arch, batch, n_frames, prompt = ENCDEC
    dev = resolve_device()
    cfg = get_config(arch)
    params = models.init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    frames = torch.randn((batch, n_frames, cfg.d_model), generator=gen,
                         device=dev).to(params.embed.dtype)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            generator=gen, device=dev)
    cache_len = prompt + NEW

    def encode():
        return models.init_cache(cfg, params, batch, cache_len,
                                 frames=frames, use_kernels=True)

    row, cache = _profiled("encdec_encoder", encode)
    yield row
    for t in range(prompt):
        logits, cache = models.decode_step(params, cache, prompts[:, t], t,
                                           cfg)
    tok = torch.argmax(logits, dim=-1)
    step = iter(range(prompt, prompt + NEW))

    def decode():
        out, _ = models.decode_step(params, cache, tok, next(step), cfg)
        return torch.argmax(out, dim=-1)

    yield _profiled("encdec_decode_step", decode)[0]
    del params, cache
    torch.cuda.empty_cache()


@torch.inference_mode()
def run_vlm():
    """phi-3-vision-4.2b at full width, bf16: one prefill of the prefix
    and the prompts (kernels on) and one greedy decode step, each after
    a warm-up."""
    arch, batch, n_prefix, prompt = VLM
    dev = resolve_device()
    cfg = get_config(arch)
    params = models.init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            generator=gen, device=dev)
    prefix = torch.randn((batch, n_prefix, cfg.d_model), generator=gen,
                         device=dev).to(params.embed.dtype)
    total = n_prefix + prompt

    def prefill():
        return models.prefill(params, prompts, cfg, total + NEW,
                              prefix_emb=prefix, use_kernels=True,
                              last_only=True)

    row, (logits, cache) = _profiled("vlm_prefill", prefill)
    yield row
    tok = torch.argmax(logits[:, -1], dim=-1)
    step = iter(range(total, total + NEW))

    def decode():
        out, _ = models.decode_step(params, cache, tok, next(step), cfg)
        return torch.argmax(out, dim=-1)

    yield _profiled("vlm_decode_step", decode)[0]
    del params, cache
    torch.cuda.empty_cache()


def _record(fn):
    """Profile one call of ``fn`` -> (prof, fn's result, wall seconds,
    launch counter deltas of that call).  The session runs a warm-up
    step of ``fn`` whose trace is discarded, then the recorded step
    (``torch.profiler.schedule``): on the card a session that recorded
    from its start held no device record of its first kernels."""
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with profile(activities=acts, schedule=sched) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        before = launch_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: n - before[k] for k, n in launch_counts().items()}
        prof.step()
    return prof, result, wall, launched


def _profiled(name: str, fn, steps: int = 1):
    """Profile one call of ``fn`` after a warm-up call in the same
    session (``_record``); returns (summary, fn's result).  The summary
    raises if the trace lacks the kernels the launch counters saw
    (``check_trace``)."""
    prof, result, wall, launched = _record(fn)
    return summarize(prof, name, wall, steps, launched), result


def run_training():
    dev = resolve_device()
    cfg = get_config(ARCH)
    acfg = AdLoCoConfig(num_init_trainers=1, nodes_per_gpu=TRAIN_WORKERS,
                        num_inner_steps=1, lr_inner=3e-4,
                        initial_batch_size=TRAIN_BATCH,
                        max_batch=TRAIN_BATCH,
                        stats_probe_size=TRAIN_BATCH, stats_use_kernel=True)
    loss_fn = build_loss_fn(cfg)
    rnd = TrainerRound(loss_fn, acfg)
    pool = rnd.init_pool(
        [lm.param_dict(models.init_params(cfg, 0, device=dev))],
        make_shard_streams(cfg.vocab_size, TRAIN_SEQ, TRAIN_WORKERS,
                           device=dev))
    tr = pool.trainers[0]
    plan = rnd.plan_for(tr)
    step = rnd.cache.get(plan)
    stream = tr.streams[0]

    def inner_step():
        batch = reshape_for_plan(stream.next_batch(plan.effective_batch),
                                 plan)
        return step(tr.params, tr.inner_opt_states[0], batch)[0]

    def stats_grads():
        return batching.per_sample_grads(loss_fn, tr.params,
                                         stream.next_batch(TRAIN_BATCH))

    row, worker = _profiled("train_inner_step", inner_step)
    yield row
    row, G = _profiled("train_stats_grads", stats_grads, TRAIN_BATCH)
    yield row
    yield _profiled("train_stats_reduce", lambda: batching.requested_batch(
        batching.stats_from_matrix(G, use_kernel=True), acfg,
        TRAIN_BATCH))[0]
    del G
    workers = [worker] * TRAIN_WORKERS
    yield _profiled("train_outer", lambda: rnd.outer(tr, workers,
                                                     x_prev=tr.params))[0]


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "torch": torch.__version__}),
          flush=True)
    phases = ([run()] + [run_recurrent(*spec) for spec in RECURRENT]
              + [run_encdec(), run_vlm()])
    for rows in phases + [run_training()]:
        for row in rows:              # each printed as its phase ends
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
