"""Quickstart: AdLoCo in ~60 lines.  Port of ``examples/quickstart.py``.

Trains a reduced MicroLlama (the paper's model family) with the full
three-stage method — adaptive batching (norm test), multi-instance
training with merging, and SwitchMode gradient accumulation — on the
synthetic C4-stand-in stream, then prints the convergence / communication
history.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from repro_torch import models
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import AdLoCoConfig
from repro_torch.core import train_adloco
from repro_torch.data import make_shard_streams
from repro_torch.examples.common import example_args
from repro_torch.launch.train import trainer_seed
from repro_torch.models import lm


def main(argv=None):
    dev = example_args(__doc__, argv).device
    # 1. model: any --arch id works; 'reduced' makes it CPU-friendly
    cfg = reduced(get_config("microllama-300m"))
    print(f"model: {cfg.name}  ({cfg.param_count() / 1e6:.1f}M params)")

    # 2. AdLoCo hyperparameters (paper Table 1, scaled down for a demo)
    acfg = AdLoCoConfig(
        num_outer_steps=6,        # T
        num_inner_steps=4,        # H
        num_init_trainers=3,      # k trainer instances (MIT)
        nodes_per_gpu=2,          # M workers per trainer
        initial_batch_size=2,
        max_batch=8,              # per-device memory cap b_max
        switch_multiplier=2,      # accumulate once b_req > 2*b_max
        merge_frequency=3,        # CheckMerge cadence
        eta=0.8,                  # norm-test threshold
        lr_inner=3e-4, lr_outer=0.5,
        stats_probe_size=16,
        stats_use_kernel=True,    # gradstats kernels on the card
    )

    # 3. k*M data shards (the paper's D_i) + k independent inits
    k, M = acfg.num_init_trainers, acfg.nodes_per_gpu
    init_params = [lm.param_dict(models.init_params(
        cfg, trainer_seed(0, i), device=dev)) for i in range(k)]
    streams = make_shard_streams(cfg.vocab_size, seq_len=32,
                                 num_shards=k * M, seed=0, device=dev)
    loss_fn = lambda p, b: models.loss_fn(p, b, cfg)  # noqa: E731

    # 4. run Algorithm 3
    pool, hist = train_adloco(loss_fn, init_params, streams, acfg,
                              verbose=True, device=dev)

    print("\nouter  loss    pool  requested_batches  comm_events  mode")
    for i, t in enumerate(hist.outer_step):
        print(f"{t:4d}  {hist.loss[i]:7.4f}  {hist.pool_size[i]:3d}  "
              f"{str(hist.requested_batches[i]):18s} "
              f"{hist.comm_events[i]:6d}      {hist.modes[i]}")
    print(f"\nfinal pool size: {pool.k} "
          f"(started with {acfg.num_init_trainers})")
    print(f"communication:   {pool.comms.events} events, "
          f"{pool.comms.total_bytes / 2**20:.1f} MiB (ring model)")


if __name__ == "__main__":
    main()
