"""Dry run on the meta device: trace one step of every (architecture x
input shape) on the production mesh and record its per-card cost.

Port of ``repro/launch/dryrun.py``.  Where the JAX package lowers and
compiles for 512 placeholder devices, this module opens a fake process
group of 256 (or 512) ranks at rank 0, builds the production mesh
(``launch.mesh``), lays the parameters, optimizer state and inputs out
as meta DTensors by ``repro_torch.sharding`` and ``launch.specs``, and
runs one step under ``launch.op_analysis.OpCounter``: per-card FLOPs,
bytes, collectives and memory, with no storage and no card.  The mesh
is CUDA-typed, so DTensor issues what it would on the cards (an
all-to-all where a CPU mesh would all-gather and chunk).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # every combo
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multipod # the 2-pod mesh
  PYTHONPATH=src python -m repro_torch.launch.dryrun --adloco-outer   # outer step
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch ... --shape ... --profile [--top N] [--dump FILE]

Per combination it traces
  train_4k              -> the inner step (``core.diloco.make_inner_step``:
                           forward, backward and AdamW, with SwitchMode
                           accumulation for ``--accum`` > 1)
  prefill_32k           -> prefill (KV-cache fill, last-token logits;
                           the encoder-decoder: the encoder's cross
                           cache, a self-attention cache created as the
                           decode plan lays it out, and one decode step)
  decode_32k, long_500k -> one decode step against a seq_len cache
These are the plain programs (no kernel of the port), the ones the JAX
dry run lowers.  Results land in ``build/dryrun/<arch>__<shape>__<mesh>.json``
with the JAX artifact's keys (minus ``xla_*``) and ``torch``, the
version that traced it (DTensor's sharding propagation, and so the
count, changes between versions): ``lower_s`` is the time
to lay out the sharded arguments, ``compile_s`` the time of the traced
step (eager PyTorch compiles nothing, and ``generated_code_bytes`` is
0), ``memory.temp_bytes`` the peak of the bytes the step allocated
(``op_analysis``).  The train step rematerialises each layer, as the
JAX loss does by default (``models.loss_fn``): the backward recomputes
the layer's forward, whose FLOPs and collectives are counted again, and
the peak holds one layer's activations, not every layer's.

``REPRO_BASELINE=1`` (read into ``BASELINE`` at import, as the JAX
package does) traces the baseline: the port's programs without their
activation constraints (``sharding.constrain``, within ``sharding.pin``
too, does nothing) and with full-sequence prefill logits; decode is the
same program in both modes, since both packages lower it without the
policy.  Every artifact records ``baseline``; ``--out`` keeps the two
sweeps apart (the file names are the JAX package's).  With no
constraint GSPMD still lays JAX's baseline out as its policy, so JAX's
baseline counts its policy's FLOPs; DTensor's propagation alone would
replicate work on every model card (1.72x the even split on a reduced
MicroLlama train step over a fake (2, 4) mesh).  So the port pins the
layouts GSPMD reaches with ``sharding.pin``, which holds in every mode
(``lay_out``) and constrains under the policy: the residual stream
(``lm.backbone``, ``encdec``), attention's heads or query rows
(``layers.policy_sdpa``), a row-parallel product's input
(``layers.rows_input``), the train step's logits, Mamba's x_proj output
and the MoE capacity slots.  Its train steps count the policy's
FLOPs, its prefills the policy's plus every position's logits.  The
same pins are what make torch 2.11 and 2.13 count alike, as do the
layouts DTensor needs to trace at all (the scans' and the conv's
``on_shards``, the decode attention's splits, a head merge or a row
split that no view takes), a partial sum reduced before a norm and
attention's gradient laid out as its output.

``--profile`` prints the top cost centres of one combo (the counterpart
of ``repro/launch/profile.py``; the port's ``launch.profile`` is the
card's ``torch.profiler`` report instead).

The fake process group is global to its process: ``run_combo`` destroys
it before it returns.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import models, optim, sharding
from repro_torch.configs import (ARCH_REGISTRY, ASSIGNED_ARCHS, INPUT_SHAPES,
                                 LONG_CONTEXT_ARCHS, get_config)
from repro_torch.core.diloco import make_inner_step
from repro_torch.launch import mesh as M
from repro_torch.launch import op_analysis
from repro_torch.launch import specs as S
from repro_torch.models import encdec, lm

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun")

# REPRO_BASELINE=1 traces the paper-faithful baseline configuration, as
# the JAX package's switch lowers it: no activation-sharding constraints
# (``_policy`` opens none, so ``sharding.constrain`` does nothing) and
# full-sequence prefill logits.  Read here only; the models know
# nothing of it.
BASELINE = os.environ.get("REPRO_BASELINE", "") == "1"


def big_archs():
    """Archs whose optimizer state needs ZeRO/FSDP sharding to fit."""
    return {name for name, cfg in ARCH_REGISTRY.items()
            if cfg.param_count() > 5e9}


@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks, at rank 0, for the
    duration of the block (no communication happens)."""
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------
# the traced programs
# ------------------------------------------------------------------

def _module(params, cfg):
    fam = encdec if cfg.is_encoder_decoder else lm
    return fam.from_param_dict(params, cfg)


def laid_out_like(out, ref):
    """Each DTensor of ``out`` redistributed to the placements of the
    matching tensor of ``ref`` (JAX's ``out_shardings``): a result left a
    partial sum would otherwise never be reduced."""
    if isinstance(out, dict):
        return {k: laid_out_like(v, ref[k]) for k, v in out.items()}
    if sharding.is_sharded(out) and sharding.is_sharded(ref):
        return out.redistribute(ref.device_mesh, ref.placements)
    return out


def make_train_step(cfg, accum: int):
    """(inner step, its AdamW) of the train_4k program."""
    opt = optim.adamw(2e-5, weight_decay=0.1)

    def loss(params, mb):
        return models.loss_fn(params, mb, cfg, logit_chunk=512)

    inner = make_inner_step(loss, opt, accum)

    def train_step(params, opt_state, batch):
        new, opt_new, loss_v, grads = inner(params, opt_state, batch)
        return (laid_out_like(new, params), laid_out_like(opt_new, opt_state),
                loss_v, laid_out_like(grads, params))

    return train_step, opt


def make_prefill_step(cfg, shape, mesh):
    C = S.cache_len_for(cfg, shape)
    # the encoder-decoder's fresh self-attention cache: zeros created
    # sharded as the decode plan lays the cache out (B over the data
    # axes, C over "model"), JAX's out_shardings for a new buffer
    fresh = S.decode_inputs(cfg, shape)["cache"]
    cache_specs = S.prefill_cache_specs(cfg, shape, mesh)

    def prefill_step(params, batch):
        module = _module(params, cfg)
        if cfg.is_encoder_decoder:
            frames = batch["frames"]
            cache = {name: sharding.zeros(fresh[name].shape,
                                          cache_specs[name], mesh,
                                          dtype=fresh[name].dtype,
                                          device=frames.device)
                     for name in ("k", "v")}
            cache.update(encdec.cross_cache(cfg, module, frames))
            return encdec.decode_step(module, cache, batch["tokens"][:, 0],
                                      0, cfg)
        logits, cache = lm.prefill(module, batch["tokens"], cfg, C,
                                   prefix_emb=batch.get("prefix_emb"),
                                   last_only=not BASELINE)
        return logits[:, -1], cache

    return prefill_step


def make_decode_step(cfg):
    def serve_step(params, cache, token, pos):
        return models.decode_step(_module(params, cfg), cache, token, pos,
                                  cfg)
    return serve_step


def _policy(mesh):
    if BASELINE:
        return contextlib.nullcontext()
    return sharding.activation_policy(
        M.data_axes(mesh), model_size=sharding.mesh_shape(mesh)["model"])


def build_program(cfg, shape, mesh, accum: int = 1):
    """(step, args, policy) for ``shape``'s program, its arguments laid
    out on ``mesh`` (meta DTensors on the production mesh; plain meta
    tensors on a mesh of one device); ``policy()`` opens the activation
    policy the step runs under."""
    fsdp = cfg.name in big_archs()
    a_params = S.abstract_params(cfg)
    params = sharding.param_shardings(a_params, mesh, fsdp=fsdp)
    if shape.kind == "train":
        step, opt = make_train_step(cfg, accum)
        a_opt = opt.init(a_params)            # meta params: a meta state
        opt_state = sharding.opt_state_shardings(a_opt, mesh, fsdp=fsdp)
        batch = S.train_batch_shardings(S.train_inputs(cfg, shape, accum),
                                        mesh)
        return step, (params, opt_state, batch), lambda: _policy(mesh)
    if shape.kind == "prefill":
        batch = S.prefill_batch_shardings(S.prefill_inputs(cfg, shape), mesh)
        return (make_prefill_step(cfg, shape, mesh), (params, batch),
                lambda: _policy(mesh))
    tok, pos, cache = S.decode_shardings(cfg, shape, mesh,
                                         S.decode_inputs(cfg, shape))
    # the JAX package lowers decode without the activation policy
    return (make_decode_step(cfg), (params, cache, tok, pos),
            contextlib.nullcontext)


def local_bytes(tree) -> int:
    """Bytes one card holds of ``tree``'s tensors (its shard of each
    DTensor)."""
    from torch.distributed.tensor import DTensor
    total = 0
    for t in op_analysis.tensors(tree):
        t = t._local_tensor if isinstance(t, DTensor) else t
        total += t.nbytes
    return total


def trace(counter, step, args, policy=contextlib.nullcontext):
    """Run ``step(*args)`` once under ``counter`` and ``policy()``, plain
    tensors mixing with DTensors as replicas -> the step's outputs."""
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication(), policy(), counter:
        return step(*args)


_OP_RE = re.compile(r"\b((?:aten|_c10d_functional|c10d|_dtensor)"
                    r"\.[A-Za-z_0-9]+(?:\.[A-Za-z_0-9]+)?)")


def _failing_op(exc: BaseException, counter) -> str:
    """The op an error names, else the last op the counter entered."""
    m = _OP_RE.search(str(exc))
    if m:
        return m.group(1)
    return (counter.last_op if counter is not None else None) or "unknown"


def skip_reason(cfg, shape, multi_pod: bool = False, accum: int = 1):
    """Why the combo is not traced, or None."""
    if shape.name == "long_500k" and cfg.name not in LONG_CONTEXT_ARCHS \
            and cfg.arch_type != "ssm":
        return "no sub-quadratic path"
    if shape.kind in ("train", "prefill"):
        rows = shape.global_batch // (accum if shape.kind == "train" else 1)
        cards = math.prod((M.MULTI_POD_SHAPE if multi_pod
                           else M.PRODUCTION_SHAPE)[:-1])
        if rows % cards:
            # the batch plan is the JAX package's, whose lowering refuses
            # a batch its data axes do not divide
            return (f"the reference refuses it: {rows} rows over "
                    f"{cards} data cards")
    return None


def run_combo(arch: str, shape_name: str, *, multi_pod: bool = False,
              accum: int = 1, save: bool = True, verbose: bool = True,
              profile_top: int = 0, dump: str = None, out_dir: str = OUT_DIR):
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    reason = skip_reason(cfg, shape, multi_pod, accum)
    if reason:
        result = {"arch": arch, "shape": shape_name, "status": "skipped",
                  "reason": reason, "torch": torch.__version__,
                  "baseline": BASELINE}
        if verbose:
            _print_result(result)
        return result
    mesh_name = M.mesh_name(multi_pod)
    world = 512 if multi_pod else 256
    counter = None
    t0 = time.time()
    with fake_world(world):
        mesh = M.make_production_mesh(multi_pod=multi_pod)
        try:
            step, args, policy = build_program(cfg, shape, mesh, accum)
            t_lower = time.time() - t0
            counter = op_analysis.OpCounter()
            out = trace(counter, step, args, policy)
            t_trace = time.time() - t0 - t_lower
            res = op_analysis.as_dict(counter)
            result = {
                "arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "ok", "accum": accum, "torch": torch.__version__,
                "baseline": BASELINE,
                "lower_s": round(t_lower, 1), "compile_s": round(t_trace, 1),
                "flops": res["flops"],
                "bytes_accessed": res["bytes"],
                "collective_bytes": res["collective_bytes"],
                "collective_wire_bytes": res["collective_wire_bytes"],
                "per_collective": res["per_collective"],
                "collectives": dict(res["per_collective"],
                                    wire_bytes=res["collective_wire_bytes"]),
                "memory": {
                    "argument_bytes": local_bytes(args),
                    "output_bytes": local_bytes(out),
                    "temp_bytes": res["temp_bytes"],
                    "generated_code_bytes": 0,
                },
                "params": cfg.param_count(),
                "params_active": cfg.param_count(active_only=True),
            }
            if profile_top:
                print(op_analysis.profile(counter, profile_top))
            if dump:
                with open(dump, "w") as f:
                    f.write(op_analysis.profile(counter, len(counter.rows)))
                print(f"[profile] every cost centre -> {dump}")
            del out, args
        except Exception as e:  # noqa: BLE001 -- a dry-run failure is a record
            result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                      "status": "error", "torch": torch.__version__,
                      "baseline": BASELINE, "op": _failing_op(e, counter),
                      "error": f"{type(e).__name__}: {str(e)[:1000]}",
                      "trace": traceback.format_exc()[-2000:]}
    if verbose:
        _print_result(result)
    if save:
        os.makedirs(out_dir, exist_ok=True)
        fn = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}"
                          + (f"__accum{accum}" if accum != 1 else "") + ".json")
        with open(fn, "w") as f:
            json.dump(result, f, indent=2)
    return result


def _print_result(r: dict) -> None:
    if r["status"] == "ok":
        m = r["memory"]
        print(f"[dryrun] {r['arch']:22s} {r['shape']:12s} {r['mesh']:12s} "
              f"{'BASELINE ' if r.get('baseline') else ''}OK "
              f"flops/card={r['flops']:.4e} "
              f"bytes/card={r['bytes_accessed']:.4e} "
              f"wire/card={r['collective_wire_bytes']:.4e} "
              f"args={m['argument_bytes'] / 2**30:.2f}GiB "
              f"temp={m['temp_bytes'] / 2**30:.2f}GiB "
              f"(trace {r['compile_s']}s)", flush=True)
    else:
        print(f"[dryrun] {r['arch']:22s} {r['shape']:12s} "
              f"{r.get('mesh', ''):12s} {r['status'].upper()}: "
              f"{r.get('op', '')} {r.get('reason', r.get('error', ''))[:300]}",
              flush=True)


# ------------------------------------------------------------------
# the AdLoCo outer step across pods
# ------------------------------------------------------------------

def build_adloco_outer(cfg, mesh):
    """The cross-instance program on the 2-pod mesh: each pod is one
    trainer instance (a stacked leading axis sharded over "pod").  One
    program averages the instances' pseudo-gradients with weights and
    takes the Nesterov outer step; all of AdLoCo's cross-pod traffic is
    in it."""
    npod = sharding.mesh_shape(mesh)["pod"]
    outer_opt = optim.nesterov_outer(0.5, 0.9)
    fsdp = cfg.name in big_archs()

    def outer(x_prev, instance_params, outer_state, weights):
        w = weights / torch.sum(weights)
        delta = {}
        for k, xp in x_prev.items():
            xs = instance_params[k].float()
            wk = w.reshape((npod,) + (1,) * (xs.dim() - 1))
            # a sum over the pod-sharded axis: a partial sum per pod,
            # reduced across pods
            delta[k] = xp.float() - torch.sum(wk * xs, dim=0)
        updates, new_state = outer_opt.update(delta, outer_state, x_prev)
        return (laid_out_like(optim.apply_updates(x_prev, updates), x_prev),
                laid_out_like(new_state, outer_state))

    a_params = S.abstract_params(cfg)
    fsdp_size, model_size = sharding.mesh_sizes(mesh, fsdp)
    specs = sharding.param_specs(a_params, fsdp_size=fsdp_size,
                                 model_size=model_size)
    x_prev = sharding.shard_tree(a_params, specs, mesh)
    stack = {k: sharding.distribute(
                 torch.empty((npod,) + tuple(p.shape), dtype=p.dtype,
                             device="meta"), (("pod",),) + specs[k], mesh)
             for k, p in a_params.items()}
    m = {k: torch.empty(p.shape, dtype=torch.float32, device="meta")
         for k, p in a_params.items()}
    state = {"m": sharding.shard_tree(m, specs, mesh)}
    weights = sharding.distribute(
        torch.empty((npod,), dtype=torch.float32, device="meta"), (None,),
        mesh)
    return outer, (x_prev, stack, state, weights)


def run_adloco_outer(arch: str, save: bool = True,
                     out_dir: str = OUT_DIR) -> dict:
    cfg = get_config(arch)
    mesh_name = M.mesh_name(True)
    t0 = time.time()
    counter = None
    with fake_world(512):
        mesh = M.make_production_mesh(multi_pod=True)
        try:
            step, args = build_adloco_outer(cfg, mesh)
            counter = op_analysis.OpCounter()
            trace(counter, step, args)
            res = op_analysis.as_dict(counter)
            result = {"arch": arch, "shape": "adloco_outer",
                      "mesh": mesh_name, "status": "ok",
                      "torch": torch.__version__, "baseline": BASELINE,
                      "flops": res["flops"], "bytes_accessed": res["bytes"],
                      "collective_bytes": res["collective_bytes"],
                      "collective_wire_bytes": res["collective_wire_bytes"],
                      "per_collective": res["per_collective"],
                      "compile_s": round(time.time() - t0, 1),
                      "params": cfg.param_count()}
            print(f"[dryrun] {arch:22s} adloco_outer {mesh_name} OK "
                  f"wire/card={res['collective_wire_bytes']:.4e} "
                  f"({res['per_collective']})", flush=True)
        except Exception as e:  # noqa: BLE001
            result = {"arch": arch, "shape": "adloco_outer",
                      "mesh": mesh_name, "status": "error",
                      "torch": torch.__version__, "baseline": BASELINE,
                      "op": _failing_op(e, counter),
                      "error": f"{type(e).__name__}: {str(e)[:1000]}"}
            print(f"[dryrun] {arch:22s} adloco_outer ERROR {result['op']} "
                  f"{result['error'][:300]}", flush=True)
    if save:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(
                out_dir, f"{arch}__adloco_outer__{mesh_name}.json"), "w") as f:
            json.dump(result, f, indent=2)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default=None, choices=sorted(ARCH_REGISTRY))
    ap.add_argument("--shape", default=None, choices=sorted(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true", help="sweep all combos")
    ap.add_argument("--multipod", action="store_true",
                    help="use the (2, 32, 8) two-pod mesh")
    ap.add_argument("--accum", type=int, default=1,
                    help="SwitchMode accumulation steps for train_4k")
    ap.add_argument("--adloco-outer", action="store_true",
                    help="trace the cross-instance outer step on the 2-pod "
                         "mesh for every assigned arch")
    ap.add_argument("--profile", action="store_true",
                    help="print the top cost centres of the combo")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--dump", default=None,
                    help="with --profile: write every cost centre here")
    ap.add_argument("--out", default=OUT_DIR, help="artifact directory")
    args = ap.parse_args(argv)

    if args.adloco_outer:
        failures = sum(run_adloco_outer(a, out_dir=args.out)["status"]
                       == "error" for a in ASSIGNED_ARCHS)
        print(f"[dryrun] adloco-outer done, {failures} failures")
        return 1 if failures else 0

    if args.all:
        combos = [(a, s) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    failures = 0
    for arch, shape in combos:
        r = run_combo(arch, shape, multi_pod=args.multipod, accum=args.accum,
                      profile_top=args.top if args.profile else 0,
                      dump=args.dump if args.profile else None,
                      out_dir=args.out)
        failures += r["status"] == "error"
    print(f"[dryrun] done: {len(combos)} combos, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
