"""Serving example: batched prefill + autoregressive decode with a KV
cache, across three architecture families (dense GQA, SSM, hybrid).
Port of ``examples/serve_batched.py``: on the card the prefill runs the
port's flash and scan kernels (``serve.generate``'s ``use_kernels=True``).

  PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]
"""
import time

import numpy as np
import torch

from repro_torch import models, serve
from repro_torch.configs import get_config, reduced
from repro_torch.examples.common import example_args


def demo(arch: str, n_requests: int = 4, prompt_len: int = 12,
         new_tokens: int = 16, *, device=None):
    cfg = reduced(get_config(arch))
    params = models.init_params(cfg, 0, device=device)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (n_requests, prompt_len)),
        dtype=torch.long, device=device)

    kw = {}
    if cfg.is_encoder_decoder:
        kw["frames"] = torch.as_tensor(
            rng.standard_normal((n_requests, cfg.num_prefix_tokens,
                                 cfg.d_model)), dtype=torch.float32,
            device=device)
    elif cfg.frontend is not None:
        kw["prefix_emb"] = torch.as_tensor(
            rng.standard_normal((n_requests, cfg.num_prefix_tokens,
                                 cfg.d_model)), dtype=torch.float32,
            device=device)

    t0 = time.time()
    res = serve.generate(params, cfg, prompts, max_new_tokens=new_tokens,
                         temperature=0.0,
                         cache_len=prompt_len + new_tokens + 4, **kw)
    wall = time.time() - t0
    tput = n_requests * new_tokens / wall
    print(f"{arch:22s} [{cfg.arch_type:6s}] {n_requests} reqs x "
          f"{new_tokens} tokens in {wall:5.1f}s  ({tput_fmt(tput)})  "
          f"first request: {res.tokens[0][:8]}...")


def tput_fmt(tps: float) -> str:
    return f"{tps:6.1f} tok/s"


def main(argv=None):
    dev = example_args(__doc__, argv).device
    print(f"batched greedy decoding, reduced configs, {dev.type}:")
    for arch in ("qwen3-0.6b",          # dense GQA + qk-norm
                 "falcon-mamba-7b",     # attention-free SSM (O(1) state)
                 "hymba-1.5b",          # hybrid attn+SSM heads
                 "gemma3-4b",           # sliding-window dense
                 "whisper-small"):      # enc-dec with audio-frame stub
        demo(arch, device=dev)


if __name__ == "__main__":
    main()
