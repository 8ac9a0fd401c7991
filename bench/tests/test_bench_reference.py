"""The reference against the port on a tiny CPU model, and the inputs
the benchmark makes against the port's own."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench.reference import model as rmodel
from bench.reference import optim as roptim
from bench.reference import train as rtrain
from bench.traffic import MarkovTokenStream, make_pool
from bench.weights import Dense, leaf_specs, make_weights
from repro_torch import models, optim
from repro_torch.configs.base import ModelConfig
from repro_torch.core import batching
from repro_torch.core.diloco import make_outer_step, value_and_grad
from repro_torch.data import make_shard_streams
from repro_torch.models import lm

M = Dense(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=96,
          vocab_size=128, rope_theta=10000.0, rms_eps=1e-5, dtype="float32")
CFG = ModelConfig(name="tiny", arch_type="dense", num_layers=2, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=128,
                  rms_eps=1e-5, dtype="float32")


def _tokens(B=2, S=24, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, M.vocab_size, (B, S), generator=g)


def _port_loss(params, tokens):
    return models.loss_fn(params, {"tokens": tokens}, CFG)[0]


def test_leaves_are_the_ports():
    port = lm.param_dict(models.init_params(CFG, 0, device="cpu"))
    ours = make_weights(M, 3, "cpu")
    assert list(ours) == list(port)
    assert all(ours[k].shape == port[k].shape and
               ours[k].dtype == port[k].dtype for k in port)
    assert [n for n, _, _ in leaf_specs(M)] == list(port)


def test_weights_follow_the_seed():
    a, b = make_weights(M, 7, "cpu"), make_weights(M, 7, "cpu")
    c = make_weights(M, 8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    assert float(a["final_norm"].abs().sum()) == 0.0
    assert a["layers.0.attn.q"].std().item() == \
        pytest.approx(M.d_model ** -0.5, rel=0.1)


def test_tokens_are_the_ports_stream():
    port = make_shard_streams(M.vocab_size, 16, 2, seed=2 ** 31 + 9,
                              device="cpu")
    pool = make_pool(M.vocab_size, 16, 2, 6, 2 ** 31 + 9, "cpu")
    for p, s in zip(port, pool):
        assert torch.equal(p.next_batch(6)["tokens"], s.rows)
    # wrapping round
    s = pool[0]
    s.next_batch(4)
    tail = s.next_batch(4)["tokens"]
    assert torch.equal(tail, torch.cat([s.rows[4:], s.rows[:2]]))
    assert s.draws == [(0, 4), (4, 4)]
    assert isinstance(MarkovTokenStream(8, 4).next_batch(1), np.ndarray)


def test_loss_and_gradients_equal_the_ports():
    w = make_weights(M, 1, "cpu")
    tok = _tokens()
    loss_p, _, g_p = value_and_grad(
        lambda p, b: models.loss_fn(p, b, CFG), w, {"tokens": tok})
    loss_r, g_r = rtrain.batch_grads(M, w, tok, None)
    assert loss_r == pytest.approx(float(loss_p), rel=1e-5)
    for k in w:
        torch.testing.assert_close(g_r[k], g_p[k], rtol=1e-4, atol=1e-6)


def test_adamw_and_nesterov_equal_the_ports():
    w = make_weights(M, 2, "cpu")
    g = {k: torch.randn_like(t) for k, t in w.items()}
    port = optim.adamw(1e-3, weight_decay=0.1)
    st = port.init(w)
    ours = roptim.AdamW(w, 1e-3, 0.1)
    p_port, p_ours = w, w
    for _ in range(3):
        upd, st = port.update(g, st, p_port)
        p_port = optim.apply_updates(p_port, upd)
        p_ours = ours.step(p_ours, g)
    for k in w:
        torch.testing.assert_close(p_ours[k], p_port[k], rtol=1e-6,
                                   atol=1e-7)
    outer = make_outer_step(optim.nesterov_outer(0.5, momentum=0.9))
    ws = [p_port, {k: t * 0.5 for k, t in w.items()}]
    stacked = {k: torch.stack([ws[0][k], ws[1][k]]) for k in w}
    x_port, _ = outer(w, stacked,
                      optim.nesterov_outer(0.5, momentum=0.9).init(w))
    x_ours = roptim.nesterov_first(w, ws, 0.5, 0.9)
    for k in w:
        torch.testing.assert_close(x_ours[k], x_port[k], rtol=0, atol=0)


def test_probe_statistics_equal_the_ports():
    w = make_weights(M, 4, "cpu")
    rows = _tokens(B=4, S=16, seed=3)
    st = batching.per_sample_probe(
        lambda p, b: models.loss_fn(p, b, CFG), w, {"tokens": rows}).stats
    inp = rtrain.Inputs(model=M, seed=4, steps=[], lr=0.0, weight_decay=0.0,
                        lr_outer=0.5, momentum=0.9, workers=[w],
                        probe_rows=rows, probe_current=1, eta=0.8,
                        max_global_batch=64)
    ref = rtrain._probe(inp)
    assert ref["n2"] == pytest.approx(float(st.mean_norm2), rel=1e-4)
    assert ref["sigma2"] == pytest.approx(float(st.sigma2), rel=1e-4)
    want = min(max(int(batching.norm_test(st, 0.8).item()), 1), 64)
    assert ref["decision"] == want


def test_fp8_control_departs_and_straight_through():
    t = torch.randn(64, 64, requires_grad=True)
    q = rmodel.fp8(t)
    assert 1e-3 < float((q - t).abs().max() / t.abs().max()) < 0.1
    q.sum().backward()
    assert torch.equal(t.grad, torch.ones_like(t))
    w = make_weights(M, 5, "cpu")
    tok = _tokens(B=1)[0]
    ref = float(rmodel.row_loss(M, w, tok))
    low = float(rmodel.row_loss(M, w, tok, quant="fp8"))
    assert ref != low and abs(ref - low) / ref < 0.05
