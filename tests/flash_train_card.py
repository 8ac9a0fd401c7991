"""Card checks of the flash-attention training route (the tensor-core
forward with its log-sum-exp and the backward kernels), shared by the
``gpu`` tests of ``test_torch_flash_attention.py`` and runnable alone on
a card where JAX is not installed:

    PYTHONPATH=src:tests python3 -c "import flash_train_card as c; c.main()"

Each check raises AssertionError with its numbers on a failure and
returns them otherwise.

Tolerances.  The kernels and the plain path's autograd (``layers.sdpa``
in bf16) round at the same products (P and the score gradient to bf16
before the products that take them), but not in the same order, so both
are held to a float32 reference on the same bf16 values (``sdpa`` in f32)
and the kernel's relative error (Frobenius norm of the difference over
the reference's) may not exceed the plain path's by more than
``GRAD_SLACK`` times, plus ``GRAD_FLOOR`` where the plain path's error is
near 0.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import kernel, ops
from repro_torch.models.layers import sdpa

# (B, S, H, Hk, hd): stablelm-1.6b's and phi3-medium-14b's training
# shapes at B 2; a ragged S (1000: the last tile 40 rows) and B 1
TRAIN_SHAPES = [
    (2, 2048, 32, 32, 64),
    (2, 2048, 40, 10, 128),
    (2, 1000, 32, 32, 64),
    (1, 1000, 40, 10, 128),
    (1, 2048, 32, 32, 64),
]
GRAD_SLACK = 1.5
GRAD_FLOOR = 2e-3
# the log-sum-exp against torch.logsumexp of the f32 scaled logits:
# both sum in f32, the kernel over 64-key tiles in base 2
LSE_TOL = 1e-4


def inputs(B, S, H, Hk, hd, seed=0):
    """q, k, v and the output's gradient, bf16 on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def t(h):
        return torch.randn((B, S, h, hd), generator=gen,
                           device="cuda").to(torch.bfloat16)
    return t(H), t(Hk), t(Hk), t(H)


def rel(got, want) -> float:
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


def grads_of(fn, q, k, v, do):
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    with torch.enable_grad():
        out = fn(q, k, v)
        out.backward(do.to(out.dtype))
    return out.detach(), q.grad, k.grad, v.grad


def check_grads(shape) -> dict:
    """Output and q, k, v gradients of the training route against the
    plain path's autograd in bf16, both against f32."""
    q, k, v, do = inputs(*shape)
    ops.reset_train_counts()
    kern = grads_of(ops.flash_attention_train, q, k, v, do)
    torch.cuda.synchronize()
    counts = (ops.train_fwd_launches, ops.train_bwd_launches)
    plain = grads_of(lambda *a: sdpa(*a, causal=True), q, k, v, do)
    ref = grads_of(lambda *a: sdpa(*a, causal=True),
                   *(t.float() for t in (q, k, v)), do.float())
    row = {"shape": list(shape), "launches": counts}
    ok = counts == (1, 1)
    for name, a, b, r in zip(("o", "dq", "dk", "dv"), kern, plain, ref):
        ek, ep = rel(a, r), rel(b, r)
        row[name] = {"kernel_rel_err": ek, "plain_rel_err": ep,
                     "finite": bool(torch.isfinite(a).all())}
        ok = ok and row[name]["finite"] and ek <= GRAD_SLACK * ep + GRAD_FLOOR
    row["ok"] = ok
    if not ok:
        raise AssertionError(f"training route disagrees: {row}")
    return row


def check_lse_forward(shape) -> dict:
    """The forward with its log-sum-exp writes the same output bits as
    the serving forward, and the log-sum-exp of the f32 scaled logits."""
    q, k, v, _ = inputs(*shape, seed=1)
    B, S, H, Hk, hd = shape
    o_serve, path = kernel.flash_attention_fwd(q, k, v, causal=True,
                                               window=ops.GLOBAL_WINDOW)
    o, lse = kernel.flash_attention_fwd_lse(q, k, v)
    torch.cuda.synchronize()
    qg = q.float().reshape(B, S, Hk, H // Hk, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    want = torch.logsumexp(logits.masked_fill(~mask, -math.inf), -1)
    got = lse[..., :S].reshape(B, Hk, H // Hk, S)
    err = (got - want).abs().max().item()
    row = {"shape": list(shape), "path": path,
           "bitwise_equal": torch.equal(o, o_serve), "lse_max_abs_err": err,
           "lse_padding_finite": bool(torch.isfinite(lse).all())}
    if not (row["bitwise_equal"] and err <= LSE_TOL
            and row["lse_padding_finite"] and path == "tc"):
        raise AssertionError(f"LSE forward: {row}")
    return row


def check_step_counts(arch: str = "stablelm-1.6b", B: int = 1,
                      S: int = 2048) -> dict:
    """One ``models.loss_fn`` step with gradients (remat) at full width:
    every layer's attention on the kernels, forward and recompute, and
    no CUDA training call on the plain path."""
    from repro_torch import models
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    params = models.lm.param_dict(models.init_params(cfg, 0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, device="cuda")}
    leaves = {n: t.detach().requires_grad_(True) for n, t in params.items()}
    ops.reset_train_counts()
    with torch.enable_grad():
        loss, _ = models.loss_fn(leaves, batch, cfg, remat=True)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    torch.cuda.synchronize()
    L = cfg.num_layers
    row = {"arch": arch, "layers": L,
           "train_fwd_launches": ops.train_fwd_launches,
           "train_bwd_launches": ops.train_bwd_launches,
           "train_plain_calls": ops.train_plain_calls,
           "loss": float(loss),
           "grads_finite": all(bool(torch.isfinite(g).all()) for g in grads)}
    del params, leaves, grads
    torch.cuda.empty_cache()
    if (row["train_fwd_launches"], row["train_bwd_launches"],
            row["train_plain_calls"]) != (2 * L, L, 0) \
            or not row["grads_finite"] or not math.isfinite(row["loss"]):
        raise AssertionError(f"step counts: {row}")
    return row


def main() -> None:
    import json
    for shape in TRAIN_SHAPES:
        print(json.dumps({"check": "lse_forward",
                          **check_lse_forward(shape)}), flush=True)
        print(json.dumps({"check": "grads", **check_grads(shape)}),
              flush=True)
    print(json.dumps({"check": "step_counts", **check_step_counts()}),
          flush=True)
