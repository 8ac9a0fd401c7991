"""Training launcher: AdLoCo (Algorithm 3) on one CUDA card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch microllama-300m \\
      --outer-steps 4 --inner-steps 8 --trainers 2 --workers 2 \\
      --seq-len 128

Port of ``repro/launch/train.py``, with its flags and printed lines,
plus ``--device`` (default ``cuda``; tests pass ``cpu``),
``--stats-probe-size`` and ``--stats-estimator`` (the AdLoCoConfig
fields, defaults as there).  The trainer pool is orchestrated host-side
over eager steps on the one device.  The batch statistics run through
the gradstats kernels (``stats_use_kernel=True``); attention runs on
the plain path, as in the JAX package's training, except causal bf16
attention of hd 64 or 128 with no window on the card, which takes the
flash kernels' forward and backward (``layers.policy_sdpa``); the
Mamba blocks' selective scan the associative scan through autograd (the CUDA scan
kernel is forward-only).  It trains the dense, moe, ssm, hybrid and
vlm families; a VLM (phi-3-vision-4.2b) trains text-only, as the JAX
launcher does, since the token streams carry no prefix.  An
encoder-decoder (whisper-small) raises ``NotImplementedError`` before
any init: its loss needs encoder frames in every batch, which the
streams do not make (the JAX launcher fails there with
``KeyError: 'frames'``).  After the run, one ``[train] stats probe`` line per
round that ran the per-sample probe gives its B and, where G did not
fit the card, the rows per chunk (``batching.per_sample_probe``).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from repro_torch import models, resolve_device
from repro_torch.checkpoint import latest_step, save_train_state
from repro_torch.configs import (ARCH_REGISTRY, PORT_ARCHS, get_config,
                                  reduced)
from repro_torch.configs.base import AdLoCoConfig
from repro_torch.core import train_adloco
from repro_torch.data import make_shard_streams
from repro_torch.models import lm


def build_loss_fn(cfg, *, logit_chunk=None):
    def loss_fn(params, batch):
        return models.loss_fn(params, batch, cfg, logit_chunk=logit_chunk)
    return loss_fn


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="microllama-300m",
                    choices=sorted(ARCH_REGISTRY) + sorted(PORT_ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="2-layer reduced variant (CPU-friendly)")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the model to this many layers, widths "
                         "unchanged (a depth cut, to fit one card)")
    ap.add_argument("--outer-steps", type=int, default=4)
    ap.add_argument("--inner-steps", type=int, default=8)
    ap.add_argument("--trainers", type=int, default=2)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--initial-batch", type=int, default=2)
    ap.add_argument("--lr-inner", type=float, default=3e-4)
    ap.add_argument("--lr-outer", type=float, default=0.5)
    ap.add_argument("--eta", type=float, default=0.8)
    ap.add_argument("--batch-test", default="norm",
                    choices=["norm", "inner_product", "augmented"])
    ap.add_argument("--no-adaptive", action="store_true")
    ap.add_argument("--no-merge", action="store_true")
    ap.add_argument("--no-switch", action="store_true")
    ap.add_argument("--merge-frequency", type=int, default=3)
    ap.add_argument("--stats-probe-size", type=int,
                    default=AdLoCoConfig.stats_probe_size,
                    help="per-sample gradients per stats probe (a memory "
                         "cap: the probe's (B, D) f32 matrix is B*D*4 "
                         "bytes)")
    ap.add_argument("--stats-estimator", default="per_sample",
                    choices=["per_sample", "microbatch"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint in --ckpt-dir "
                         "before training")
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for tests)")
    return ap.parse_args(argv)


def make_configs(args):
    """(ModelConfig, AdLoCoConfig) of the parsed flags."""
    cfg = get_config(args.arch)
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name} is an encoder-decoder: its loss needs encoder "
            "frames in every batch, and the launcher's token streams make "
            "none (the JAX launcher fails with KeyError: 'frames')")
    lm.check_arch(cfg)
    if args.reduced:
        cfg = reduced(cfg)
    if args.num_layers is not None:
        cfg = cfg.with_overrides(num_layers=args.num_layers)
    acfg = AdLoCoConfig(
        num_outer_steps=args.outer_steps,
        num_inner_steps=args.inner_steps,
        lr_inner=args.lr_inner,
        lr_outer=args.lr_outer,
        num_init_trainers=args.trainers,
        nodes_per_gpu=args.workers,
        initial_batch_size=args.initial_batch,
        merge_frequency=args.merge_frequency,
        eta=args.eta,
        max_batch=args.max_batch,
        batch_test=args.batch_test,
        adaptive=not args.no_adaptive,
        enable_merge=not args.no_merge,
        enable_switch=not args.no_switch,
        stats_probe_size=args.stats_probe_size,
        stats_estimator=args.stats_estimator,
        stats_use_kernel=True,
        seed=args.seed,
    )
    return cfg, acfg


def trainer_seed(seed: int, i: int) -> int:
    """Init seed of trainer ``i``: distinct per (seed, i)."""
    return int(np.random.SeedSequence([seed, i]).generate_state(1)[0])


def run(argv=None):
    """Parse ``argv``, train, print the launcher's lines, write the
    checkpoint and history if asked.  Returns (pool, history,
    ModelConfig)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg, acfg = make_configs(args)

    k, M = acfg.num_init_trainers, acfg.nodes_per_gpu
    init_params = [lm.param_dict(models.init_params(
        cfg, trainer_seed(acfg.seed, i), device=dev)) for i in range(k)]
    streams = make_shard_streams(cfg.vocab_size, args.seq_len, k * M,
                                 seed=acfg.seed, device=dev)
    loss_fn = build_loss_fn(cfg)

    print(f"[train] arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"k={k} M={M} H={acfg.num_inner_steps} T={acfg.num_outer_steps}")

    restore_from = None
    if args.resume and args.ckpt_dir:
        step = latest_step(args.ckpt_dir)
        if step is not None:
            restore_from = (args.ckpt_dir, step)
            print(f"[train] resuming from {args.ckpt_dir} step {step}")

    pool, hist = train_adloco(loss_fn, init_params, streams, acfg,
                              verbose=True, restore_from=restore_from,
                              device=dev)
    for t, probes in zip(hist.outer_step, hist.stats_probe):
        for B, rows, chunks in probes:
            how = ("one pass" if chunks == 1
                   else f"{chunks} row chunks of {rows}")
            print(f"[train] t={t} stats probe B={B}: {how}")
    print(f"[train] final loss={hist.loss[-1]:.4f} "
          f"comm_events={pool.comms.events} "
          f"comm_GB={pool.comms.total_bytes/2**30:.3f}")
    if args.ckpt_dir:
        save_train_state(args.ckpt_dir, acfg.num_outer_steps, pool)
        print(f"[train] checkpoint -> {args.ckpt_dir}")
    if args.history_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.history_out)),
                    exist_ok=True)
        with open(args.history_out, "w") as f:
            json.dump(hist.as_dict(), f, indent=2)
        print(f"[train] history -> {args.history_out}")
    return pool, hist, cfg


def main(argv=None):
    # full-width training holds optimizer states, workers and the probe's
    # G in large blocks; expandable segments keep the blocks freed between
    # them usable (read when the CUDA allocator starts, so set before any
    # CUDA call; a value the caller set is kept)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
