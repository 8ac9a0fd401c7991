"""DeepSeek-V2's decoder in the port (``DeepseekV2Config``: MLA, a
leading dense layer, MoE layers that may hold a share of the experts)
against the plain float32 reference ``reference_deepseek_v2``, on the
CPU at a small size: d 64, 4 heads, kv_lora 32, q/k 32 + 16 (rope), v
16, 8 experts top-2 with 1 shared, 3 layers with the first dense, f32.

Weights are seeded numpy draws, norms included.  Logits, loss, aux and
every leaf's gradient agree to 1e-4 relative (float32 on both sides; the
largest differences are a few 1e-6), at every expert held and at a
share; a token whose top-k choice sits within 1e-5 of the next would
route apart on round-off, and the seeds here have none.  The shares of
all 8 experts, with the shared expert counted once, add up to the whole
layer's output and aux, capacity drops included.
"""
import contextlib
import dataclasses
import json

import numpy as np
import pytest
import torch

import reference_deepseek_v2 as ref
from repro_torch import models, spans
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import DeepseekV2Config, MoEConfig
from repro_torch.core.diloco import step_spans, value_and_grad
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as L
from repro_torch.models import lm
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)

TINY = DeepseekV2Config(
    name="tiny-v2", arch_type="moe", num_layers=3, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=32, vocab_size=128, rms_eps=1e-6,
    moe=MoEConfig(num_experts=8, top_k=2, num_shared=1, d_expert=32),
    kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16,
    v_head_dim=16, first_k_dense=1, dense_d_ff=96, norm_topk=False,
    dtype="float32")
RTOL = 1e-4


def sizes(cfg: DeepseekV2Config) -> ref.Sizes:
    mc = cfg.moe
    return ref.Sizes(
        num_layers=cfg.num_layers, d_model=cfg.d_model,
        num_heads=cfg.num_heads, kv_lora_rank=cfg.kv_lora_rank,
        qk_nope_head_dim=cfg.qk_nope_head_dim,
        qk_rope_head_dim=cfg.qk_rope_head_dim, v_head_dim=cfg.v_head_dim,
        first_k_dense=cfg.first_k_dense, vocab_size=cfg.vocab_size,
        num_experts=mc.num_experts, top_k=mc.top_k, num_shared=mc.num_shared,
        held=cfg.held, norm_topk=cfg.norm_topk, rope_theta=cfg.rope_theta,
        rms_eps=cfg.rms_eps, aux_coef=mc.load_balance_coef)


def weights(cfg: DeepseekV2Config, seed: int = 0):
    """The training dict of ``cfg`` drawn from numpy: normal 1/sqrt(fan
    in), the embedding 0.02, the norms 0.1 (so that 1 + w shows)."""
    shapes = {k: tuple(t.shape) for k, t in lm.param_dict(
        models.init_params(cfg, 0, device="cpu")).items()}
    rng = np.random.default_rng(seed)
    out = {}
    for k, shp in shapes.items():
        if len(shp) == 1:
            std = 0.1
        elif k == "embed":
            std = 0.02
        else:
            std = shp[-2] ** -0.5
        out[k] = torch.from_numpy(rng.standard_normal(shp) * std).float()
    return out


def share(w, cfg: DeepseekV2Config, held: range):
    """``w`` with each MoE layer's expert leaves cut to ``held``."""
    return {k: (t[held.start:held.stop] if k.split(".")[-1] in
                ("gate", "up", "down") and ".moe." in k else t)
            for k, t in w.items()}


def tokens(cfg, B=2, S=24, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, S), generator=g)


def close(a, b, rtol=RTOL):
    a, b = torch.as_tensor(a).detach(), torch.as_tensor(b).detach()
    scale = max(float(b.abs().max()), 1e-6)
    assert float((a - b).abs().max()) <= rtol * scale, (
        float((a - b).abs().max()), scale)


@pytest.mark.parametrize("held", [None, range(4, 8)], ids=["all", "share"])
def test_logits_loss_aux_and_grads_match_reference(held):
    cfg = dataclasses.replace(TINY, experts_held=held)
    w = share(weights(TINY), cfg, cfg.held)
    toks = tokens(cfg)
    s = sizes(cfg)
    want_logits, want_aux = ref.forward(s, w, toks)
    got_logits, got_aux = lm.forward(lm.from_param_dict(w, cfg), toks, cfg)
    close(got_logits, want_logits)
    close(got_aux, want_aux)

    leaves = {k: t.clone().requires_grad_(True) for k, t in w.items()}
    rl, rce, raux = ref.loss(s, leaves, toks)
    rgrads = torch.autograd.grad(rl, list(leaves.values()))
    loss, aux, grads = value_and_grad(
        lambda p, b: models.loss_fn(p, b, cfg), w, {"tokens": toks})
    close(loss, rl)
    close(aux["aux"], raux)
    assert float(raux.detach()) > 0
    for (k, g), rg in zip(grads.items(), rgrads):
        assert g.shape == rg.shape, k
        close(g, rg)


@pytest.mark.parametrize("norm_topk", [False, True])
def test_router_weights_renormalised_only_when_asked(norm_topk):
    cfg = dataclasses.replace(TINY, norm_topk=norm_topk)
    w = weights(cfg, 3)
    toks = tokens(cfg, seed=3)
    want, _ = ref.forward(sizes(cfg), w, toks)
    got, _ = lm.forward(lm.from_param_dict(w, cfg), toks, cfg)
    close(got, want)
    other, _ = ref.forward(dataclasses.replace(sizes(cfg),
                                               norm_topk=not norm_topk),
                           w, toks)
    assert float((other - want).abs().max()) > 1e-3


def test_mla_matches_reference():
    """The latent attention alone: the 32-wide latent norm and rotary on
    16 of each head's 48 q/k dims, v 16 wide."""
    w = weights(TINY, 5)
    attn = {k.rsplit(".", 1)[1]: t for k, t in w.items()
            if k.startswith("layers.1.attn.")}
    x = torch.randn((2, 20, TINY.d_model),
                    generator=torch.Generator().manual_seed(5))
    got = L.mla_attention(attn, x, TINY, torch.arange(20))
    close(got, ref.mla(sizes(TINY), attn, x))


def test_sdpa_with_v_narrower_than_q_and_k():
    g = torch.Generator().manual_seed(7)
    q, k = (torch.randn((2, 10, 4, 48), generator=g) for _ in range(2))
    v = torch.randn((2, 10, 4, 16), generator=g)
    out = L.sdpa(q, k, v, causal=True)
    assert out.shape == (2, 10, 4, 16)
    s = torch.einsum("bqhn,bkhn->bhqk", q, k) / 48 ** 0.5
    s = s.masked_fill(~torch.ones(10, 10, dtype=torch.bool).tril(), -1e30)
    close(out, torch.einsum("bhqk,bkhn->bqhn", torch.softmax(s, -1), v))


def test_training_route_refuses_unequal_head_widths(monkeypatch):
    """On a pretended card, bf16 q/k 128 with v 64 or 128 with 192 stay
    plain and are counted; equal widths of 128 take the route."""
    monkeypatch.setattr(flash_ops, "records_cuda_grad", lambda q: (
        torch.is_grad_enabled() and q.requires_grad))

    def qkv(hq, hv):
        t = [torch.zeros((1, 64, 4, h), dtype=torch.bfloat16,
                         requires_grad=True) for h in (hq, hq, hv)]
        return t
    assert flash_ops.takes_train_kernel(*qkv(128, 128), causal=True)
    assert not flash_ops.takes_train_kernel(*qkv(128, 64), causal=True)
    assert not flash_ops.takes_train_kernel(*qkv(192, 128), causal=True)
    flash_ops.reset_train_counts()
    with torch.enable_grad():
        L.policy_sdpa(*qkv(192, 128), TINY, causal=True)
    assert flash_ops.train_plain_calls == 1
    assert flash_ops.train_fwd_launches == 0
    flash_ops.reset_train_counts()


def test_expert_shares_add_up_to_the_whole_layer():
    """Guide's tie test: 8 shares of one expert each.  Each share's
    routed part (its output less the shared expert's) summed, plus the
    shared expert once, is the uncut layer's output; every share's aux
    is the uncut layer's.  Tokens that share a common part load the
    experts unevenly, so that some assignments overflow capacity."""
    cfg = dataclasses.replace(TINY, moe=dataclasses.replace(
        TINY.moe, top_k=3))
    w = weights(cfg, 9)
    p = {k.rsplit(".", 1)[1]: t for k, t in w.items()
         if k.startswith("layers.1.moe.")}
    x = torch.randn((96, cfg.d_model),
                    generator=torch.Generator().manual_seed(9)) + 1.0
    whole, whole_aux = L.moe_block(p, x, cfg)
    r = L.moe_route(p, x, cfg)
    assert not bool(r.kept.all())               # capacity drops happen
    shared = L.swiglu(x, p["s_gate"][0], p["s_up"][0], p["s_down"][0])
    total = shared.clone()
    for e in range(8):
        c = dataclasses.replace(cfg, experts_held=range(e, e + 1))
        pe = {k: (t[e:e + 1] if k in ("gate", "up", "down") else t)
              for k, t in p.items()}
        y, aux = L.moe_block(pe, x, c)
        total = total + (y - shared)
        close(aux, whole_aux, 1e-6)
    close(total, whole, 1e-5)


def test_counts_once_per_token_and_spans_nest():
    """Under ``step_spans`` the layers open ``mla`` (3 a pass) and ``moe``
    (2 a pass) inside ``forward`` and, for the remat recompute, inside
    ``backward``; the router's assignments count once per token."""
    cfg = dataclasses.replace(TINY, experts_held=range(0, 4))
    w = share(weights(TINY), cfg, cfg.held)
    toks = tokens(cfg)
    opened, stack = [], []

    @contextlib.contextmanager
    def span(name):
        opened.append((name, stack[-1] if stack else None))
        stack.append(name)
        try:
            yield
        finally:
            stack.pop()
    L.reset_moe_counts()
    with step_spans(span):
        value_and_grad(lambda p, b: models.loss_fn(p, b, cfg), w,
                       {"tokens": toks}, span)
    model = [o for o in opened if o[0] in ("mla", "moe")]
    assert sorted(set(model)) == [("mla", "backward"), ("mla", "forward"),
                                  ("moe", "backward"), ("moe", "forward")]
    assert model.count(("mla", "forward")) == 3
    assert model.count(("moe", "forward")) == 2
    n = toks.numel() * cfg.moe.top_k * 2
    got = L.moe_counts()
    assert got["routed"] == n
    assert got["kept"] + got["dropped"] == got["held"] <= n
    assert got["held"] > 0
    L.reset_moe_counts()
    assert isinstance(spans.span("x"), contextlib.nullcontext)


def test_config_records_and_registry():
    from repro_torch.configs import ARCH_REGISTRY, PORT_ARCHS
    cfg = get_config("deepseek-v2-lite")
    assert "deepseek-v2-lite" in PORT_ARCHS
    assert "deepseek-v2-lite" not in ARCH_REGISTRY
    assert (cfg.d_model, cfg.num_heads, cfg.kv_lora_rank, cfg.qk_head_dim,
            cfg.v_head_dim, cfg.dense_d_ff, cfg.moe.d_expert,
            cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.num_shared,
            cfg.vocab_size) == (2048, 16, 512, 192, 128, 10944, 1408, 64, 6,
                                2, 102400)
    assert cfg.param_count() == pytest.approx(15.7e9, rel=0.01)
    cut = cfg.with_overrides(num_layers=9, experts_held=range(8))
    assert cut.param_count() == pytest.approx(1.30e9, rel=0.01)
    assert reduced(cfg).kv_lora_rank == 32


def test_serving_refuses_latent_attention():
    cfg = reduced(get_config("deepseek-v2-lite"))
    params = models.init_params(cfg, 0, device="cpu")
    toks = tokens(cfg, 1, 8)
    with pytest.raises(NotImplementedError, match="latent"):
        models.prefill(params, toks, cfg, 16)
    with pytest.raises(NotImplementedError, match="latent"):
        models.init_cache(cfg, params, 1, 16)
    with pytest.raises(NotImplementedError, match="latent"):
        models.init_paged_cache(cfg, 1, 4, 8, device="cpu")


def test_launcher_trains_deepseek_v2_lite(tmp_path, capsys):
    argv = ["--arch", "deepseek-v2-lite", "--reduced", "--device", "cpu",
            "--outer-steps", "2", "--inner-steps", "1", "--seq-len", "16",
            "--trainers", "1", "--workers", "2", "--stats-probe-size", "4",
            "--history-out", str(tmp_path / "hist.json")]
    assert launch_train.main(argv) == 0
    out = capsys.readouterr().out
    assert "[train] arch=deepseek-v2-lite-smoke" in out
    hist = json.loads((tmp_path / "hist.json").read_text())
    assert len(hist["loss"]) == 2 and all(np.isfinite(hist["loss"]))
