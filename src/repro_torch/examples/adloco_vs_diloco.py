"""Paper Figure 1 at demo scale: AdLoCo vs vanilla DiLoCo convergence
and communication on the same shards, with an ASCII plot.  Port of
``examples/adloco_vs_diloco.py``.

  PYTHONPATH=src python -m repro_torch.examples.adloco_vs_diloco [--device cpu]
"""
import dataclasses

from repro_torch.configs.base import AdLoCoConfig
from repro_torch.core import train_adloco, train_diloco
from repro_torch.examples.common import example_args, quad_loss, quad_setup


def ascii_plot(series: dict, width: int = 60, height: int = 14):
    """series: {label: [(x, y), ...]} — x = comm events, y = eval loss."""
    all_pts = [p for pts in series.values() for p in pts]
    xs = [p[0] for p in all_pts]
    ys = [p[1] for p in all_pts]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    grid = [[" "] * width for _ in range(height)]
    marks = "ox+*"
    for (label, pts), mark in zip(series.items(), marks):
        for x, y in pts:
            i = int((1 - (y - y0) / max(y1 - y0, 1e-9)) * (height - 1))
            j = int((x - x0) / max(x1 - x0, 1e-9) * (width - 1))
            grid[i][j] = mark
    print(f"  eval loss {y1:.3f}")
    for r in grid:
        print("  |" + "".join(r))
    print("  +" + "-" * width + f"> comm events ({x0}..{x1})")
    for (label, _), mark in zip(series.items(), marks):
        print(f"    {mark} = {label}")


def main(argv=None):
    dev = example_args(__doc__, argv).device
    acfg = AdLoCoConfig(
        num_outer_steps=12, num_inner_steps=5, lr_inner=0.05, lr_outer=0.7,
        num_init_trainers=3, nodes_per_gpu=2, initial_batch_size=2,
        merge_frequency=3, eta=0.8, max_batch=16, inner_optimizer="sgd",
        stats_probe_size=64, stats_use_kernel=True)

    print("convex proxy (deterministic E[f] metric), 3 trainers x 2 workers")
    _, inits, streams, eval_fn = quad_setup(k=3, M=2, seed=0, device=dev)
    _, hist_a = train_adloco(quad_loss, inits, streams, acfg,
                             eval_fn=eval_fn, device=dev)

    _, inits2, streams2, eval2 = quad_setup(k=3, M=2, seed=0, device=dev)
    _, hist_d = train_diloco(
        quad_loss, inits2[0], streams2[:2],
        dataclasses.replace(acfg, num_outer_steps=36),
        fixed_batch=2, num_outer_steps=36, eval_fn=eval2, device=dev)

    ascii_plot({
        "AdLoCo (adaptive batch + merge + switch)":
            list(zip(hist_a.comm_events, hist_a.eval_loss)),
        "DiLoCo (fixed batch)":
            list(zip(hist_d.comm_events, hist_d.eval_loss)),
    })
    print(f"\n  AdLoCo : final E[f]={hist_a.eval_loss[-1]:.4f} "
          f"after {hist_a.comm_events[-1]} comm events "
          f"({hist_a.samples[-1]} samples, final batches "
          f"{hist_a.requested_batches[-1]})")
    print(f"  DiLoCo : final E[f]={hist_d.eval_loss[-1]:.4f} "
          f"after {hist_d.comm_events[-1]} comm events "
          f"({hist_d.samples[-1]} samples, fixed batch 2)")


if __name__ == "__main__":
    main()
