"""Where the main paths' time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile

Serving: ``serve.generate``'s two phases at the main path's shapes
(microllama-300m, bf16, 4 prompts of 512 tokens, 32 greedy tokens) —
one prefill (flash kernel on) and the greedy decode steps; then the SSM
and hybrid serving paths at ``chip_smoke.py``'s shapes (falcon-mamba-7b,
bf16, 4 prompts of 512 tokens; hymba-1.5b, bf16, 2 prompts of 1536
tokens) — one prefill (kernels on) and one decode step each.  Training:
the phases of one AdLoCo trainer round at the training main path's
shapes (microllama-300m, bf16 with f32 AdamW state, seq 128, batch 8,
M = 2 workers) — one inner step, the per-sample gradients of a probe of
8, their gradstats reduction (kernels on), and the outer step.

Each phase runs under ``torch.profiler`` on seeded random weights, after
one warm-up call, and prints one JSON line: host wall time, device busy
time (the union of the phase's CUDA kernel intervals), the device's idle
share of the phase's window, launches per step, and the kernels with the
most device time and the host ops with the most self CPU time.  Needs a
CUDA card; the profiler adds host time per launch, so wall times here
run above ``chip_smoke.py``'s.
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
from repro_torch.launch.train import build_loss_fn
from repro_torch.models import lm

ARCH, BATCH, PROMPT, NEW, TOP = "microllama-300m", 4, 512, 32, 8
# (arch, batch, prompt, phase-name prefix) of the SSM and hybrid paths
RECURRENT = (("falcon-mamba-7b", 4, 512, "ssm"),
             ("hymba-1.5b", 2, 1536, "hybrid"))
TRAIN_SEQ, TRAIN_BATCH, TRAIN_WORKERS = 128, 8, 2


def _kernel_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _busy_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def summarize(prof, name: str, wall_s: float, steps: int) -> dict:
    kernels = _kernel_events(prof)
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
    out = []

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, cache = models.prefill(params, prompts, cfg, PROMPT + NEW,
                                       use_kernels=True, last_only=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out.append(summarize(prof, "prefill", wall, 1))

    tok = torch.argmax(logits[:, -1], dim=-1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(NEW - 1):
            logits, cache = models.decode_step(params, cache, tok,
                                               PROMPT + i, cfg)
            tok = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out.append(summarize(prof, "decode", wall, NEW - 1))
    return out


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
    tok = torch.argmax(logits[:, -1], dim=-1)
    step = iter(range(prompt, prompt + NEW))

    def decode():
        out, _ = models.decode_step(params, cache, tok, next(step), cfg)
        return torch.argmax(out, dim=-1)

    row2, _ = _profiled(f"{name}_decode_step", decode)
    del params, cache
    torch.cuda.empty_cache()
    return [row, row2]


def _profiled(name: str, fn, steps: int = 1):
    """Warm ``fn`` up once, then profile one call; returns (summary,
    fn's result)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return summarize(prof, name, wall, steps), result


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

    out = []
    row, worker = _profiled("train_inner_step", inner_step)
    out.append(row)
    row, G = _profiled("train_stats_grads", stats_grads, TRAIN_BATCH)
    out.append(row)
    row, _ = _profiled("train_stats_reduce", lambda: batching.requested_batch(
        batching.stats_from_matrix(G, use_kernel=True), acfg, TRAIN_BATCH))
    out.append(row)
    del G
    workers = [worker] * TRAIN_WORKERS
    row, _ = _profiled("train_outer", lambda: rnd.outer(tr, workers,
                                                        x_prev=tr.params))
    out.append(row)
    return out


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "torch": torch.__version__}),
          flush=True)
    rows = run()
    for spec in RECURRENT:
        rows += run_recurrent(*spec)
    for row in rows + run_training():
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
