"""Training cells of a DeepSeek-V2 decoder (MLA, leading dense layers,
MoE layers holding a share of the experts): AdLoCo rounds of the port's
``TrainerRound``, as ``bench.kinds.train`` runs a dense decoder.

The configuration file holds the model's published ``config.json`` keys
(``bench.reference.moe_weights.LatentMoE.of`` reads them) and the experts
held here; ``model_config`` makes the port's ``DeepseekV2Config`` of
them.  Weights come from ``bench.reference.moe_weights``, tokens from the
traffic's device pool, and the step is ``models.loss_fn`` with remat
through ``launch.train.build_loss_fn``, as in the dense cells (the same
loss head: whole f32 logits).  Set-up runs round 1 through the
window's own calls (``bench.kinds.train.Trainer.round1``: ``Capture``
reads the program's side of the check); the reference
(``bench.reference.moe_train``) routes by itself.  The window counts
the MoE layers' assignments (``layers.moe_counts``: routed, to a held
expert, kept, dropped) and the attention calls on and off the flash
training route.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from bench import trace as btrace
from bench.kinds import train as ktrain
from bench.record import Round, Run
from bench.reference import moe_train as ref
from bench.reference.moe_weights import LatentMoE, make_weights
from bench.spec import Cell
from bench.traffic import make_pool
from repro_torch.configs.base import DeepseekV2Config, MoEConfig
from repro_torch.core.adloco import TrainerRound
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.train import build_loss_fn
from repro_torch.models import layers


def model_config(m: LatentMoE, name: str) -> DeepseekV2Config:
    """The port's record of the sizes ``m``."""
    return DeepseekV2Config(
        name=name, arch_type="moe", num_layers=m.num_layers,
        d_model=m.d_model, num_heads=m.num_heads, num_kv_heads=m.num_heads,
        d_ff=m.d_expert, vocab_size=m.vocab_size, rope_theta=m.rope_theta,
        rms_eps=m.rms_eps, dtype=m.dtype,
        moe=MoEConfig(num_experts=m.num_experts, top_k=m.top_k,
                      num_shared=m.num_shared, d_expert=m.d_expert,
                      load_balance_coef=m.aux_coef),
        kv_lora_rank=m.kv_lora_rank, qk_nope_head_dim=m.qk_nope_head_dim,
        qk_rope_head_dim=m.qk_rope_head_dim, v_head_dim=m.v_head_dim,
        first_k_dense=m.first_k_dense, dense_d_ff=m.dense_d_ff,
        norm_topk=m.norm_topk, experts_held=m.held)


@dataclass
class MoERun(Run):
    # ``layers.moe_counts()`` over the window: routed, held, kept, dropped
    moe: Dict[str, int] = field(default_factory=dict)
    # attention calls in the window: on the flash training route, plain
    attention: Dict[str, int] = field(default_factory=dict)


class Trainer(ktrain.Trainer):
    """The system under test: one ``TrainerRound`` of the cell's model at
    a fixed batch of ``b_max``."""

    def __init__(self, cell: Cell, seed: int, device):
        self.dev = torch.device(device)
        config, traffic = cell.config, cell.traffic
        self.model = LatentMoE.of(config)
        self.acfg = acfg = ktrain.adloco_config(config, traffic)
        self.seq_len = int(traffic["seq_len"])
        if acfg.adaptive or acfg.num_inner_steps <= ref.STEPS:
            raise ValueError(f"{cell.name}: a fixed batch and more than "
                             f"{ref.STEPS} inner steps are read")
        self.fixed = int(config["b_max"])
        self.seed = seed
        self.streams = make_pool(self.model.vocab_size, self.seq_len,
                                 acfg.nodes_per_gpu,
                                 int(traffic["pool_rows"]), seed, self.dev)
        self.rnd = TrainerRound(
            build_loss_fn(model_config(self.model, config["name"])), acfg)
        self.pool = self.rnd.init_pool(
            [make_weights(self.model, seed, self.dev)], self.streams)
        self.tr = self.pool.trainers[0]
        self.t = 0


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """One run of a DeepSeek-V2 training cell -> {"run": MoERun,
    "numbers", "attempted", "failed", "peak_bytes"}."""
    tn = Trainer(cell, seed, device)
    dev = tn.dev
    prog, inputs = tn.round1()
    setup_peak = ktrain._peak(dev)

    def window():
        rounds: List[Round] = []
        t0 = time.perf_counter()
        while True:
            rounds.append(tn.round())
            if time.perf_counter() - t0 >= seconds:
                break
        ktrain._sync(dev)
        return rounds, time.perf_counter() - t0

    ktrain._sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    layers.reset_moe_counts()
    flash_ops.reset_train_counts()
    setup_s = time.perf_counter() - t_start
    if trace:
        prof, (rounds, window_s) = btrace.record(window)
    else:
        rounds, window_s = window()
    window_peak = ktrain._peak(dev)
    record = MoERun(
        cell=cell.name, model=tn.model, seq_len=tn.seq_len, setup_s=setup_s,
        window_s=window_s, rounds=rounds, window_peak_bytes=window_peak,
        moe=layers.moe_counts(),
        attention={"route": flash_ops.train_fwd_launches,
                   "plain": flash_ops.train_plain_calls})
    if trace:
        record.trace = btrace.summarize(prof, {})
        del prof

    # ---- the check, once the program's state is freed -----------------
    tn.free()
    t_ref = time.perf_counter()
    numbers = ref.compare(prog, ref.reference(inputs, dev))
    print(f"[bench] reference: {time.perf_counter() - t_ref:.1f} s; "
          f"rounds in the window (plan, sequences, s): "
          f"{[(r.mode, r.samples, round(r.seconds, 3)) for r in rounds]}; "
          f"allocator per round: {[r.alloc for r in rounds]}; "
          f"MoE assignments: {record.moe}; attention calls: "
          f"{record.attention}", file=sys.stderr)
    return {"run": record, "numbers": numbers,
            "attempted": sum(r.samples for r in rounds), "failed": 0,
            "peak_bytes": max(setup_peak, window_peak)}
