"""Training-state checkpoints in the JAX package's format: one ``.npz``
per tree plus a ``meta.json`` sidecar (port of ``repro/checkpoint``).

Keys are the JAX package's ``jax.tree_util.keystr`` paths over its
parameter tree, whose layers are stacked on a leading L axis: the port's
flat name ``layers.3.attn.q`` is row 3 of the array stored under
``['layers']['attn']['q']``, and ``m``/``v`` of an optimizer state nest
above it (``['m']['layers']['attn']['q']``).  bf16 is stored as f32,
which holds every bf16 value, and restored to the template's dtype.  A
checkpoint written by either package restores into the other.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def _keystr(path: Tuple[str, ...]) -> str:
    return "".join(f"[{p!r}]" for p in path)


def _split(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """``layers.3.attn.q`` -> (("layers", "attn", "q"), 3)."""
    parts = name.split(".")
    idx = [i for i, p in enumerate(parts) if p.isdigit()]
    if not idx:
        return tuple(parts), None
    if len(idx) > 1:
        raise ValueError(f"{name!r}: more than one stacked index")
    i = idx[0]
    return tuple(parts[:i] + parts[i + 1:]), int(parts[i])


def _entries(obj, prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[str, Optional[int], torch.Tensor]]:
    """(key, layer index or None, tensor) for every tensor of a port
    state: a dict of tensors and dicts, or an empty tuple."""
    if isinstance(obj, (tuple, list)):
        if obj:
            raise ValueError("only an empty tuple state is supported")
        return
    for k, v in obj.items():
        if isinstance(v, torch.Tensor):
            path, idx = _split(k)
            yield _keystr(prefix + path), idx, v
        else:
            yield from _entries(v, prefix + (k,))


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def save_pytree(path: str, tree) -> None:
    arrays: Dict[str, Any] = {}
    rows: Dict[str, Dict[int, np.ndarray]] = {}
    for key, idx, t in _entries(tree):
        if idx is None:
            arrays[key] = _numpy(t)
        else:
            rows.setdefault(key, {})[idx] = _numpy(t)
    for key, by_idx in rows.items():
        arrays[key] = np.stack([by_idx[i] for i in range(len(by_idx))])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def _restore(like, data, prefix: Tuple[str, ...] = ()):
    if isinstance(like, (tuple, list)):
        return like
    out = {}
    for k, leaf in like.items():
        if not isinstance(leaf, torch.Tensor):
            out[k] = _restore(leaf, data, prefix + (k,))
            continue
        path, idx = _split(k)
        key = _keystr(prefix + path)
        arr = data[key] if idx is None else data[key][idx]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"{key}[{idx}]: checkpoint shape {arr.shape}, "
                             f"expected {tuple(leaf.shape)}")
        out[k] = torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=leaf.device, dtype=leaf.dtype)
    return out


def restore_pytree(path: str, like):
    """Restore into the structure of ``like`` (shape/dtype/device
    template)."""
    with np.load(path) as data:
        return _restore(like, data)


def save_json(path: str, obj: Any) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=str)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def save_train_state(ckpt_dir: str, step: int, pool_state) -> None:
    """pool_state: repro_torch.core.mit.TrainerPoolState."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    for i, tr in enumerate(pool_state.trainers):
        save_pytree(os.path.join(d, f"trainer_{i}_params.npz"), tr.params)
        save_pytree(os.path.join(d, f"trainer_{i}_outer_opt.npz"),
                    tr.outer_opt_state)
        for m, st in enumerate(tr.inner_opt_states):
            save_pytree(os.path.join(d, f"trainer_{i}_inner_opt_{m}.npz"), st)
    if pool_state.global_params is not None:
        save_pytree(os.path.join(d, "global_params.npz"),
                    pool_state.global_params)
    save_json(os.path.join(d, "meta.json"), {
        "step": step,
        "num_trainers": len(pool_state.trainers),
        "requested_batches": [int(t.requested_batch)
                              for t in pool_state.trainers],
        "comms_bytes": float(pool_state.comms.total_bytes),
        "comms_events": int(pool_state.comms.events),
    })


def restore_train_state(ckpt_dir: str, step: int, pool_state):
    """Restore a checkpoint into ``pool_state`` (whose trainers provide
    the shape/dtype/device templates: freshly initialised with the same
    config and pool size)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    meta = load_json(os.path.join(d, "meta.json"))
    if meta["num_trainers"] != len(pool_state.trainers):
        raise ValueError(f"checkpoint has {meta['num_trainers']} trainers, "
                         f"the pool {len(pool_state.trainers)}")
    for i, tr in enumerate(pool_state.trainers):
        tr.params = restore_pytree(
            os.path.join(d, f"trainer_{i}_params.npz"), tr.params)
        tr.outer_opt_state = restore_pytree(
            os.path.join(d, f"trainer_{i}_outer_opt.npz"),
            tr.outer_opt_state)
        tr.inner_opt_states = [
            restore_pytree(os.path.join(d, f"trainer_{i}_inner_opt_{m}.npz"),
                           st)
            for m, st in enumerate(tr.inner_opt_states)]
        tr.requested_batch = int(meta["requested_batches"][i])
    gp = os.path.join(d, "global_params.npz")
    if os.path.exists(gp) and pool_state.trainers:
        pool_state.global_params = restore_pytree(
            gp, pool_state.trainers[0].params)
    return pool_state, meta


def latest_step(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
             if n.startswith("step_")]
    return max(steps) if steps else None
