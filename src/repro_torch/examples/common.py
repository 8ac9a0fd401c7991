"""Setups the examples and the multi-process launcher share.  Port of
``benchmarks/common.py``'s setups (its timing rows are benchmark
plumbing and stay there).

Initial parameters are drawn with numpy from the seed: the JAX
package's PRNG bits are not reproduced, so the convex proxy's starting
points differ from ``benchmarks.common.quad_setup``'s while its streams,
loss and evaluation are the same functions of the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import models, resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.data import MarkovTokenStream, QuadraticProblem
from repro_torch.launch.train import trainer_seed
from repro_torch.models import lm


class QuadStream:
    """Adapter: QuadraticProblem -> the trainer-stream protocol."""

    def __init__(self, prob: QuadraticProblem, shard: int, seed: int = 0):
        self.prob = prob
        self.rng = np.random.default_rng(np.random.SeedSequence([seed, shard]))

    def next_batch(self, b):
        A, y = self.prob.sample(b, self.rng)
        return {"A": A, "y": y}


def quad_loss(params, batch):
    r = batch["A"] @ params["x"] - batch["y"]
    return 0.5 * torch.mean(torch.square(r)), {}


def quad_init(dim: int, seed: int, i: int) -> np.ndarray:
    """Trainer ``i``'s starting point: standard normal f32 from a numpy
    stream apart from every data shard's."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, i, 1]))
    return rng.standard_normal(dim).astype(np.float32)


def quad_setup(k: int = 3, M: int = 2, dim: int = 16, noise: float = 2.0,
               seed: int = 0, *, device=None):
    """(problem, k inits, k*M streams, deterministic E[f] evaluation) of
    the convex proxy, on ``device`` (``cuda`` unless named)."""
    dev = resolve_device(device)
    prob = QuadraticProblem(dim=dim, noise=noise, seed=seed, device=dev)
    inits = [{"x": torch.from_numpy(quad_init(dim, seed, i)).to(dev)}
             for i in range(k)]
    streams = [QuadStream(prob, i, seed=seed) for i in range(k * M)]
    x_star = torch.as_tensor(prob.x_star, dtype=torch.float32, device=dev)
    eval_fn = lambda p: 0.5 * float(  # noqa: E731  — deterministic E[f]
        torch.sum(torch.square(p["x"] - x_star))) + 0.5 * prob.noise ** 2
    return prob, inits, streams, eval_fn


def lm_setup(k: int = 2, M: int = 2, seq_len: int = 32, seed: int = 0, *,
             device=None):
    """Reduced microllama (the paper's model family) + Markov stream."""
    dev = resolve_device(device)
    cfg = reduced(get_config("microllama-300m"))
    inits = [lm.param_dict(models.init_params(cfg, trainer_seed(seed, i),
                                              device=dev))
             for i in range(k)]
    streams = [MarkovTokenStream(cfg.vocab_size, seq_len, shard=i, seed=seed,
                                 device=dev)
               for i in range(k * M)]
    loss_fn = lambda p, b: models.loss_fn(p, b, cfg)  # noqa: E731
    held = MarkovTokenStream(cfg.vocab_size, seq_len, shard=999, seed=seed,
                             device=dev).next_batch(16)

    @torch.no_grad()
    def eval_fn(p):
        return float(loss_fn(p, held)[0])

    return cfg, inits, streams, loss_fn, eval_fn


def to_target(hist, target: float):
    """(samples, comm_events, outer_step) when eval first <= target."""
    for loss, s, ev, t in zip(hist.eval_loss, hist.samples,
                              hist.comm_events, hist.outer_step):
        if loss <= target:
            return s, ev, t
    return None, None, None


def example_args(doc: str, argv=None, extra=None):
    """Parse an example's command line: ``--device`` (``cuda`` unless
    named; raises without a card) and the ``extra(ap)`` arguments."""
    import argparse

    ap = argparse.ArgumentParser(
        description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="where the example runs: cuda (the default; raises "
                         "without a card) or cpu")
    if extra is not None:
        extra(ap)
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    return args
