"""End-to-end driver: pre-train a ~100M-parameter MicroLlama-family model
with AdLoCo for a few hundred inner steps, with checkpointing and a JSON
history dump — the paper's experiment (§6.1) at one-card scale.  Port of
``examples/train_100m.py``.

  PYTHONPATH=src python -m repro_torch.examples.train_100m         # full run
  PYTHONPATH=src python -m repro_torch.examples.train_100m --demo  # demo

The full run performs T=10 outer rounds x H=8 inner steps x M=2 workers
x k=2..1 trainers ~= 300+ optimizer steps on a 97M model, on the card
(``--device cpu`` runs it on the CPU).  The checkpoint and
``history.json`` go to ``build/examples/train_100m/``.
"""
import json
import os
import time

import torch

from repro_torch import models
from repro_torch.checkpoint import save_train_state
from repro_torch.configs import get_config
from repro_torch.configs.base import AdLoCoConfig
from repro_torch.core import train_adloco
from repro_torch.data import make_shard_streams
from repro_torch.examples.common import example_args
from repro_torch.launch.train import trainer_seed
from repro_torch.models import lm

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                   "..", "build", "examples", "train_100m")


def build_config(demo: bool):
    """~97M params: MicroLlama geometry, 6 layers of d=768."""
    cfg = get_config("microllama-300m").with_overrides(
        name="microllama-97m", num_layers=6, d_model=768, num_heads=12,
        num_kv_heads=4, d_ff=2048, dtype="float32")
    if demo:
        cfg = cfg.with_overrides(num_layers=2, d_model=256, num_heads=4,
                                 d_ff=512, vocab_size=2048,
                                 name="microllama-demo")
    return cfg


def _flags(ap):
    ap.add_argument("--demo", action="store_true",
                    help="tiny model / short run")
    ap.add_argument("--outer-steps", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)


def main(argv=None):
    args = example_args(__doc__, argv, _flags)
    dev = args.device

    cfg = build_config(args.demo)
    T = args.outer_steps or (4 if args.demo else 10)
    seq = args.seq_len or (32 if args.demo else 128)
    acfg = AdLoCoConfig(
        num_outer_steps=T, num_inner_steps=8, lr_inner=3e-4, lr_outer=0.5,
        num_init_trainers=2, nodes_per_gpu=2, initial_batch_size=2,
        merge_frequency=4, eta=0.8, max_batch=8, switch_multiplier=2,
        stats_probe_size=8, weight_decay=0.1, stats_use_kernel=True)

    n = cfg.param_count()
    steps = T * acfg.num_inner_steps * acfg.nodes_per_gpu \
        * acfg.num_init_trainers
    print(f"[100m] {cfg.name}: {n / 1e6:.1f}M params, "
          f"up to {steps} inner optimizer steps "
          f"(T={T} x H={acfg.num_inner_steps} x M={acfg.nodes_per_gpu} "
          f"x k<={acfg.num_init_trainers}), seq_len={seq}")

    k, M = acfg.num_init_trainers, acfg.nodes_per_gpu
    init_params = [lm.param_dict(models.init_params(
        cfg, trainer_seed(0, i), device=dev)) for i in range(k)]
    streams = make_shard_streams(cfg.vocab_size, seq, k * M, seed=0,
                                 device=dev)
    loss_fn = lambda p, b: models.loss_fn(p, b, cfg)  # noqa: E731

    # held-out eval shard
    held = make_shard_streams(cfg.vocab_size, seq, 1, seed=77,
                              device=dev)[0]
    eval_batch = held.next_batch(8)

    @torch.no_grad()
    def eval_fn(p):
        return float(loss_fn(p, eval_batch)[0])

    t0 = time.time()
    pool, hist = train_adloco(loss_fn, init_params, streams, acfg,
                              eval_fn=eval_fn, verbose=True, device=dev)
    wall = time.time() - t0

    os.makedirs(OUT, exist_ok=True)
    save_train_state(OUT, T, pool)
    with open(os.path.join(OUT, "history.json"), "w") as f:
        json.dump(hist.as_dict(), f, indent=2)
    print(f"\n[100m] done in {wall:.0f}s: "
          f"train {hist.loss[0]:.3f} -> {hist.loss[-1]:.3f}, "
          f"eval {hist.eval_loss[0]:.3f} -> {hist.eval_loss[-1]:.3f}")
    print(f"[100m] comm: {pool.comms.events} events "
          f"{pool.comms.total_bytes / 2**30:.2f} GiB; "
          f"final pool k={pool.k}; "
          f"batches {hist.requested_batches[0]} -> "
          f"{hist.requested_batches[-1]}")
    print(f"[100m] checkpoint + history -> {os.path.abspath(OUT)}")


if __name__ == "__main__":
    main()
