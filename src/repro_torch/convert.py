"""Parameter conversion between the JAX package's pytree and the port's
modules (``DecoderLM``, ``EncDecLM``).

The JAX tree is nested dicts of numpy arrays with the layers stacked on
a leading L axis (``jax.device_get(repro.models.init_params(...))``).
Both sides keep the ``(d_in, d_out)`` orientation, so a conversion is a
copy.  numpy has no bfloat16: bf16 arrays arrive as ml_dtypes' bfloat16
(read through their 16-bit pattern) and leave as float32, which holds
every bf16 value exactly.

Leaves are cast to the model dtype, except those that the JAX init
keeps in f32 in any model, which stay f32 both ways: the Mamba leaves
(``layers.MAMBA_F32_LEAVES``: dt_b, A_log, D) and the MoE router
(``layers.MOE_F32_LEAVES``).  The layer trees of every family the port
runs (dense, moe, ssm, hybrid, vlm, and the encoder-decoder's two
stacks, ``enc_layers`` and ``dec_layers``, with their MLP biases)
convert with the same walk; both functions dispatch on the config.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, lm
from repro_torch.models.layers import MAMBA_F32_LEAVES, MOE_F32_LEAVES
from repro_torch.models.lm import _dtype


def _to_tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype)


_F32_LEAVES = {"mamba": MAMBA_F32_LEAVES, "moe": MOE_F32_LEAVES}


def _leaf_dtype(path, dtype):
    if len(path) >= 2 and path[-1] in _F32_LEAVES.get(path[-2], ()):
        return torch.float32
    return dtype


def _unstack(tree, i: int, dtype, device, path=()):
    if isinstance(tree, dict):
        return {k: _unstack(v, i, dtype, device, path + (k,))
                for k, v in tree.items()}
    return _to_tensor(np.asarray(tree)[i], _leaf_dtype(path, dtype), device)


def params_from_numpy(tree: Dict, cfg: ModelConfig, device=None):
    """JAX parameter pytree (numpy leaves, stacked layers) -> DecoderLM,
    or EncDecLM for an encoder-decoder config, in ``cfg.dtype`` on
    ``device`` (``cuda`` unless named)."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    if cfg.is_encoder_decoder:
        stacks = {"enc_layers": cfg.encoder_layers,
                  "dec_layers": cfg.num_layers}
        norms = ("embed", "enc_norm", "final_norm")
    else:
        stacks = {"layers": cfg.num_layers}
        norms = ("embed", "final_norm") + (
            () if cfg.tie_embeddings else ("lm_head",))
    out = {k: _to_tensor(tree[k], dt, dev) for k in norms}
    out.update({k: [_unstack(tree[k], i, dt, dev) for i in range(n)]
                for k, n in stacks.items()})
    return (encdec.EncDecLM if cfg.is_encoder_decoder
            else lm.DecoderLM)(cfg, out)


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _stack(layer_trees):
    first = layer_trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in layer_trees]) for k in first}
    return np.stack(layer_trees)


def params_to_numpy(params) -> Dict:
    """DecoderLM or EncDecLM -> the JAX pytree layout (numpy leaves,
    stacked layers)."""
    flat = {k: _numpy(t) for k, t in params.named_parameters()}
    stacks = (encdec._STACKS if params.cfg.is_encoder_decoder
              else ("layers",))
    tree = lm._nest(flat, stacks)
    for k in stacks:
        tree[k] = _stack(tree[k])
    return tree
