"""Per-card counts on a model axis that the heads do not divide, held
against the JAX package's, and the decode attention that splits a
sharded cache over the cards.

The ratio of a program is its per-card FLOPs on a fake mesh times the
card count, over the same package's count on one card in the same mode:
1.0 is an even split.  Reduced configs (2 layers, d 256) with the head
counts below (hd 64), B = 8, S = 64, on a fake (2, 4) ("data",
"model") mesh (one case on (2, 2)).  JAX's side runs
``repro.launch.dryrun``'s ``lower_train`` / ``lower_decode`` /
``lower_prefill`` and ``hlo_analysis`` in one subprocess, since that
module sets a 512-device ``XLA_FLAGS`` at import; its meshes take
``Auto`` axes (jax 0.9.0's default ``Explicit`` axes make
``with_sharding_constraint`` raise).  The subprocess starts with the
first test and the port's counts run while it works.

The port's train and decode ratios are at most JAX's in every case.
JAX's own ratios are 1.000 except whisper-small 6 / 6 (train 1.055,
prefill 1.017) and deepseek-moe-16b 4 / 4 (train 1.176, the MoE rule
order of ROADMAP section 3 item 9).  Under the baseline (no activation
constraints) GSPMD lays JAX's train steps out as its policy does, so
JAX's baseline ratios equal its policy ratios; the port's baseline
pins the layouts GSPMD reaches (``sharding.pin`` and ``lay_out``) and
is held to the same bounds.  Decode at B = 1 (rows whole on every data
card) is held to JAX's ratio from both sides, and its logits on one
card to JAX's.

Nothing here imports ``repro.launch.dryrun``.  Every test leaves no
process group behind.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro.models import lm as jlm
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun, op_analysis
from repro_torch.models import layers as L
from repro_torch.models import lm
import test_torch_dense_configs as dense_tests
import test_torch_ssm as ssm_tests
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]

# (arch, heads, kv heads, program, mesh): the eight reduced cases of
# ROADMAP section 3 item 11, and deepseek-moe-16b
CASES = [("microllama-300m", 5, 1, "train", (2, 4)),
         ("hymba-1.5b", 5, 1, "train", (2, 4)),
         ("whisper-small", 6, 6, "train", (2, 4)),
         ("whisper-small", 4, 4, "train", (2, 2)),
         ("microllama-300m", 5, 1, "decode", (2, 4)),
         ("hymba-1.5b", 5, 1, "decode", (2, 4)),
         ("microllama-300m", 5, 1, "prefill", (2, 4)),
         ("whisper-small", 6, 6, "prefill", (2, 4)),
         ("deepseek-moe-16b", 4, 4, "train", (2, 4))]
BASELINE_CASES = CASES
# decode at B = 1, the long_500k plan: the cache and state over every
# card, the rows whole on each data card (the last field: the vocab, or
# None for the reduced 1,024).  The reduced vocab divides the model
# axis, so neither package splits the products over the data axes; at
# 1,001 it does not, the embedding splits d, and GSPMD splits hymba's
# products over the data cards where the model axis divides them and
# keeps x whole on a (2, 4) mesh (``layers.decode_product``).
# falcon-mamba-7b's state spreads over every card, and GSPMD runs the
# Mamba step on the model axis's channels (``layers.channels_over_model``)
DECODE_B1_CASES = [("hymba-1.5b", 5, 1, "decode", (2, 4), 1, None),
                   ("gemma3-4b", 4, 2, "decode", (2, 4), 1, None),
                   ("hymba-1.5b", 5, 1, "decode", (2, 4), 1, 1001),
                   ("hymba-1.5b", 5, 1, "decode", (4, 4), 1, 1001),
                   ("hymba-1.5b", 5, 1, "decode", (2, 2), 1, 1001),
                   ("falcon-mamba-7b", 5, 1, "decode", (2, 4), 1, None)]

JAX_SCRIPT = r"""
import dataclasses, json, sys
from repro.launch import dryrun as D          # 512 host devices
import jax
from jax.sharding import AxisType
from repro.configs import get_config, reduced
from repro.configs.base import InputShape
from repro.launch import hlo_analysis

LOWER = {"train": D.lower_train, "prefill": D.lower_prefill,
         "decode": D.lower_decode}


def flops(cfg, kind, shape, batch, seq=64):
    n = shape[0] * shape[1]
    mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                         devices=jax.devices()[:n],
                         axis_types=(AxisType.Auto,) * 2)
    low = LOWER[kind](cfg, InputShape("x", seq, batch, kind), mesh)
    return hlo_analysis.analyze(low.compile().as_text())["flops"]


out, ones = {}, {}
cases, baseline = json.loads(sys.argv[1]), json.loads(sys.argv[2])
for arch, h, hk, kind, shape, batch, vocab, *more in cases:
    seq, over = (more + [64, {}][len(more):])      # optional: S, fields
    cfg = dataclasses.replace(reduced(get_config(arch)), num_heads=h,
                              num_kv_heads=hk, head_dim=64, **over)
    if vocab:
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    at = (cfg, kind, batch, seq)
    one = ones[at] = ones.get(at) or flops(cfg, kind, (1, 1), batch, seq)
    key = (f"{arch}/{h}/{hk}/{kind}/{shape[0]}x{shape[1]}"
           + ("" if batch == 8 else f"/b{batch}")
           + (f"/v{vocab}" if vocab else "")
           + ("" if seq == 64 else f"/s{seq}")
           + "".join(f"/{k}{v}" for k, v in sorted(over.items())))
    out[key] = flops(cfg, kind, shape, batch, seq) * shape[0] * shape[1] / one
    out[key + "/one"] = one
    if batch == 8 and [arch, h, hk, kind, shape] in baseline:
        D.BASELINE = True
        # constraints change no count on one card, but the baseline's
        # prefill computes every position's logits
        if kind == "prefill":
            one = flops(cfg, kind, (1, 1), batch)
        out[key + "/baseline"] = (flops(cfg, kind, shape, batch)
                                  * shape[0] * shape[1] / one)
        D.BASELINE = False
print(json.dumps(out))
"""


def key(arch, h, hk, kind, shape, batch=8, vocab=None, seq=64, over=None):
    """The JAX script's key of a case; ``seq`` the sequence length,
    ``over`` the config fields replaced beside the heads."""
    return (f"{arch}/{h}/{hk}/{kind}/{shape[0]}x{shape[1]}"
            + ("" if batch == 8 else f"/b{batch}")
            + (f"/v{vocab}" if vocab else "")
            + ("" if seq == 64 else f"/s{seq}")
            + "".join(f"/{k}{v}" for k, v in sorted((over or {}).items())))


def case_id(case):
    arch, h, hk, kind, shape = case[:5]
    batch, vocab = (tuple(case[5:]) + (None, None))[:2]
    return (f"{arch}-{h}-{hk}-{kind}-{shape[0]}x{shape[1]}"
            + (f"-b{batch}" if batch else "")
            + (f"-v{vocab}" if vocab else ""))


class JaxRatios:
    """JAX's ratios from one subprocess, started on first use and read
    when a test first needs them."""

    def __init__(self, as_lists=None, base=()):
        """``as_lists``: the script's cases ([arch, heads, kv heads,
        kind, mesh, batch, vocab] and optionally S and a dict of config
        fields), by default this module's; ``base``: the cases also
        counted in the baseline mode."""
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu")
        if as_lists is None:
            as_lists = ([[a, h, hk, k, list(s), 8, None]
                         for a, h, hk, k, s in CASES]
                        + [[a, h, hk, k, list(s), b, v]
                           for a, h, hk, k, s, b, v in DECODE_B1_CASES])
            base = [[a, h, hk, k, list(s)]
                    for a, h, hk, k, s in BASELINE_CASES]
        self.proc = subprocess.Popen(
            [sys.executable, "-c", JAX_SCRIPT, json.dumps(as_lists),
             json.dumps(list(base))], cwd=ROOT, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        self.ratios = None

    def __getitem__(self, k):
        if self.ratios is None:
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, err[-3000:]
            self.ratios = json.loads(out.strip().splitlines()[-1])
        return self.ratios[k]


@pytest.fixture(scope="module")
def jax_ratios():
    ratios = JaxRatios()
    yield ratios
    if ratios.proc.poll() is None:
        ratios.proc.kill()
        ratios.proc.communicate()


@pytest.fixture(autouse=True)
def no_process_group_left():
    yield
    assert not dist.is_initialized()


def cfg_of(arch, h, hk, vocab=None):
    cfg = dataclasses.replace(reduced(get_config(arch)), num_heads=h,
                              num_kv_heads=hk, head_dim=64)
    return dataclasses.replace(cfg, vocab_size=vocab) if vocab else cfg


def count(cfg, kind, shape, monkeypatch=None, baseline=False, batch=8,
          seq=64):
    """The port's per-card OpCounter of ``kind``'s dry-run program."""
    if monkeypatch is not None:
        monkeypatch.setattr(dryrun, "BASELINE", baseline)
    with dryrun.fake_world(shape[0] * shape[1]):
        mesh = init_device_mesh("cuda", shape,
                                mesh_dim_names=("data", "model"))
        step, args, policy = dryrun.build_program(
            cfg, InputShape("x", seq, batch, kind), mesh)
        counter = op_analysis.OpCounter()
        dryrun.trace(counter, step, args, policy)
    return counter


def port_ratio(arch, h, hk, kind, shape, batch=8, vocab=None,
               monkeypatch=None, baseline=False):
    """The port's ratio, the one-card count taken in the same mode."""
    cfg = cfg_of(arch, h, hk, vocab)
    one = count(cfg, kind, (1, 1), monkeypatch, baseline, batch).cost.flops
    many = count(cfg, kind, shape, monkeypatch, baseline, batch).cost.flops
    return many * math.prod(shape) / one


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_per_card_ratio_at_most_jax(case, jax_ratios):
    port = port_ratio(*case)
    jax = jax_ratios[key(*case)]
    assert port <= jax + 1e-9, (case, port, jax)
    if case[3] in ("train", "decode") and case[0] != "deepseek-moe-16b":
        assert port == 1.0           # the even split itself


@pytest.mark.parametrize("case", BASELINE_CASES, ids=case_id)
def test_baseline_ratios(case, jax_ratios, monkeypatch):
    """GSPMD lays JAX's baseline out as its policy; the port's baseline,
    laid out as GSPMD lays JAX's, counts at most JAX's baseline ratio,
    and the even split itself where JAX's policy ratio is 1.0."""
    jax = jax_ratios[key(*case) + "/baseline"]
    assert jax == jax_ratios[key(*case)]
    base = port_ratio(*case, monkeypatch=monkeypatch, baseline=True)
    assert base <= jax + 1e-9, (case, base, jax)
    if case[3] in ("train", "decode") and case[0] != "deepseek-moe-16b":
        assert base == 1.0


@pytest.mark.parametrize("case", DECODE_B1_CASES, ids=case_id)
def test_batch_one_decode_held_to_jax(case, jax_ratios):
    """A decode step at B = 1, the rows whole on every data card: the
    port's ratio is at most JAX's and within 2% of it (every case's is
    JAX's to four digits: hymba-1.5b's 1.9655, 1.9654 at vocab 1,001,
    2.0677 on (4, 4), 1.5775 on (2, 2); falcon-mamba-7b's 2.0), so a
    port that counts a cheaper program than GSPMD's fails as one that
    counts more."""
    port = port_ratio(*case)
    jax = jax_ratios[key(*case)]
    assert 0.98 * jax <= port <= jax + 1e-9, (case, port, jax)


def bmm_flops(counter) -> float:
    return sum(r["flops"] for r in counter.breakdown(len(counter.rows))
               if r["op"].startswith("aten.bmm"))


def test_decode_attention_splits_a_sharded_cache_over_the_cards():
    """Reduced MicroLlama decode on a fake (1, 4) mesh, the cache's C
    over "model": each card attends its quarter of the slots for every
    head, so it counts exactly a quarter of the one-card attention
    products (``bmm``; every projection is an ``mm``)."""
    cfg = reduced(get_config("microllama-300m"))
    one = count(cfg, "decode", (1, 1))
    many = count(cfg, "decode", (1, 4))
    assert bmm_flops(one) > 0
    assert bmm_flops(many) == bmm_flops(one) / 4


def decode_attention_before(p, x, cfg, k_cache, v_cache, pos, *,
                            cache_len_valid=None, window=None,
                            kv_pos_of_slot=None):
    """``layers.decode_attention`` as it was before the sharded path was
    added: the one-card path must stay bitwise this."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q = L.split_heads(x @ p["q"], cfg.num_heads, hd)
    cos, sin = L.rope_cos_sin(L._rope_pos_for_decode(pos), hd,
                              cfg.rope_theta)
    q = L.apply_rope(q, cos, sin)
    C = k_cache.shape[1]
    slot_pos = (kv_pos_of_slot if kv_pos_of_slot is not None
                else torch.arange(C))
    slot_pos = torch.atleast_2d(slot_pos).expand(B, C)
    pos_b = pos.expand(B)[:, None]
    Hk = cfg.num_kv_heads
    qg = q.reshape(B, Hk, cfg.num_heads // Hk, hd)
    logits = torch.einsum("bkgh,bskh->bkgs", qg, k_cache).float()
    logits = logits * (1.0 / math.sqrt(hd))
    mask = (slot_pos <= pos_b) & (slot_pos >= 0)
    if cache_len_valid is not None:
        mask &= slot_pos > pos_b - cache_len_valid
    if window is not None:
        mask &= slot_pos > pos_b - window
    logits = logits.masked_fill(~mask[:, None, None, :], L.NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v_cache)
    return out.reshape(B, 1, cfg.q_dim) @ p["o"]


def decode_inputs(seed, B=3, C=40, dtype=torch.float32):
    cfg = reduced(get_config("microllama-300m"))
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=dtype)

    d, hd, Hk = cfg.d_model, cfg.resolved_head_dim, cfg.num_kv_heads
    p = {"q": t(d, cfg.q_dim) / math.sqrt(d),
         "o": t(cfg.q_dim, d) / math.sqrt(cfg.q_dim)}
    return cfg, p, t(B, 1, d), t(B, C, Hk, hd), t(B, C, Hk, hd)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("pos", [25, 39, 70])
def test_split_combine_equals_one_card_decode(pos, window):
    """Flash-decoding on plain f32 tensors: the cache cut into 4 slices
    of C (the last one shorter and, at pos 25, all masked), each slice's
    ``decode_split`` stacked and joined by ``combine_splits``, equals the
    one-card ``decode_attention`` to 1e-6; the one-card path equals its
    form before the sharded path bitwise.  At pos 70 the 40-slot cache
    is a ring (slot i holds the newest position congruent to i)."""
    cfg, p, x, k, v = decode_inputs(pos)
    C = k.shape[1]
    posv = torch.tensor(pos)
    kv_pos = posv - (posv - torch.arange(C)) % C
    one = L.decode_attention(p, x, cfg, k, v, posv, window=window,
                             kv_pos_of_slot=kv_pos)
    assert torch.equal(one, decode_attention_before(
        p, x, cfg, k, v, posv, window=window, kv_pos_of_slot=kv_pos))
    B, hd, Hk = x.shape[0], cfg.resolved_head_dim, cfg.num_kv_heads
    q = L.split_heads(x @ p["q"], cfg.num_heads, hd)
    cos, sin = L.rope_cos_sin(L._rope_pos_for_decode(posv), hd,
                              cfg.rope_theta)
    qg = L.apply_rope(q, cos, sin).reshape(B, Hk, -1, hd)
    parts = [L.decode_split(qg, k[:, lo:lo + 11], v[:, lo:lo + 11], posv,
                            kv_pos[lo:lo + 11], window=window)
             for lo in range(0, C, 11)]
    m, l, pv = (torch.stack(t, dim=-1) for t in zip(*parts))
    out = L.combine_splits(m, l, pv, x.dtype)
    split = out.reshape(B, 1, cfg.q_dim) @ p["o"]
    torch.testing.assert_close(split, one, rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "gemma3-4b"])
def test_one_card_batch_one_decode_matches_jax(arch):
    """At B = 1 on one card (plain tensors: ``layers.decode_product`` is
    ``x @ w``), a 5-token prefill and three decode steps give the JAX
    package's logits and cache, within the family tests' tolerance."""
    if arch == "hymba-1.5b":
        cfg, jcfg = ssm_tests.cfgs(arch)
        jp, tp = ssm_tests.both_params(arch)
        close = ssm_tests._close
    else:
        jcfg, cfg, jp, tp = dense_tests.both(arch)
        close = dense_tests.close
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 8))
    _, jc = jlm.prefill(jp, jnp.asarray(toks[:, :5]), jcfg, 16)
    _, tc = lm.prefill(tp, torch.from_numpy(toks[:, :5]), cfg, 16)
    for i in range(5, 8):
        want, jc = jlm.decode_step(jp, jc, jnp.asarray(toks[:, i]),
                                   jnp.int32(i), jcfg)
        got, tc = lm.decode_step(tp, tc, torch.from_numpy(toks[:, i]), i,
                                 cfg)
        close(got, want)
    for name in tc:
        close(tc[name], jc[name])
