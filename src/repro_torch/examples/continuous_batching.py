"""Continuous batching: requests of different lengths join and leave the
decode batch mid-flight — no slot idles waiting for a straggler.  Port
of ``examples/continuous_batching.py``.  The paged batcher prefills in
chunks through the paged cache (plain attention, no flash kernel).

Part 1 drives a mixed bag of requests through the paged batcher by
hand; part 2 replays a flash-crowd arrival trace and prints the
scheduler report (tokens/tick, latency percentiles, peak concurrency).

  PYTHONPATH=src python -m repro_torch.examples.continuous_batching \\
      [--device cpu]
"""
import time

import numpy as np

from repro_torch import models
from repro_torch.configs import get_config, reduced
from repro_torch.examples.common import example_args
from repro_torch.serve import traffic
from repro_torch.serve.scheduler import ContinuousBatcher, Request


def main(argv=None):
    dev = example_args(__doc__, argv).device
    cfg = reduced(get_config("qwen3-0.6b"))
    params = models.init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(0)

    # 8 requests, wildly different prompt/generation lengths, 3 slots
    reqs = [Request(rid=i,
                    tokens=[int(t) for t in
                            rng.integers(0, cfg.vocab_size,
                                         (int(rng.integers(3, 12)),))],
                    max_new_tokens=int(rng.integers(3, 14)))
            for i in range(8)]
    total_new = sum(r.max_new_tokens for r in reqs)

    cb = ContinuousBatcher(params, cfg, n_slots=3, cache_len=32)
    for r in reqs:
        cb.submit(r)
    t0 = time.time()
    done = cb.run()
    wall = time.time() - t0

    print(f"{len(done)} requests, {total_new} total new tokens, "
          f"{cb.steps} batched decode steps (vs {total_new} sequential), "
          f"{wall:.1f}s")
    for rid in sorted(done):
        r = done[rid]
        print(f"  req {rid}: prompt {len(r.tokens):2d} toks -> "
              f"{r.generated}")

    # part 2: a flash crowd lands on the paged batcher — short requests
    # hold only the blocks they touch, so concurrency can ride above
    # what a dense cache of equal memory would ever admit
    arr = traffic.make_arrivals("flash_crowd", n_requests=12, seed=3)
    cb = ContinuousBatcher(params, cfg, n_slots=6, cache_len=32,
                           block_size=8, num_blocks=12, chunk_size=4)
    rep = cb.run_trace(traffic.materialize(arr, cfg.vocab_size, seed=3))
    print(f"\nflash_crowd x12 on 12 shared blocks: "
          f"{rep.tokens} tokens in {rep.ticks} ticks "
          f"({rep.tokens_per_tick:.2f} tok/tick), "
          f"p50 latency {rep.p50_latency:.0f} ticks, "
          f"peak concurrency {rep.max_concurrency}, "
          f"peak blocks {rep.peak_blocks}, "
          f"preemptions {rep.preemptions}")


if __name__ == "__main__":
    main()
