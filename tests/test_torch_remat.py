"""Per-layer rematerialisation in the port's training losses, held
against the JAX package's ``loss_fn(..., remat=True)``, its default.

The port checkpoints where JAX's ``_run_layers`` puts ``jax.checkpoint``
(``lm.remat_spans``): one layer each, for gemma3's interleaved layers
one group of ``global_every`` layers each and then one per tail layer,
and for whisper-small the decoder layers only.  PyTorch's default early
stop leaves a layer's last product out of the recompute, as XLA's
dead-code pass leaves it out of JAX's, so the gradient's op count is
JAX's exactly (reduced configs, f32, B 2, S 64).  The recompute changes
no value: on the CPU in f32 the loss and every gradient are the same
with and without remat, bit for bit, and JAX's within the family
tests' tolerance (the loss to 1e-5, each gradient to 1e-4 relative to
its leaf's largest entry, as ``test_torch_vlm``).  Without autograd
(serving) nothing is checkpointed.

Nothing here imports ``repro.launch.dryrun``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro import models as jmodels
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import hlo_analysis
from repro.launch import specs as jspecs
from repro_torch import convert, models
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import InputShape
from repro_torch.core.diloco import value_and_grad
from repro_torch.launch import dryrun, op_analysis, specs
from repro_torch.models import encdec, lm
import test_torch_dense_configs as dense_tests
import test_torch_encdec as encdec_tests
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)

B, S = 2, 64


@pytest.fixture(autouse=True)
def no_process_group_left():
    yield
    assert not dist.is_initialized()


def configs(arch, layers=None):
    """(JAX config, port config) of ``arch`` reduced, with ``layers``
    layers where given (gemma3-4b at 7: one group of six and a tail)."""
    jcfg, cfg = jax_reduced(jax_get_config(arch)), reduced(get_config(arch))
    if layers:
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return jcfg, cfg


def test_remat_spans_follow_jax_run_layers():
    _, cfg = configs("gemma3-4b", 13)
    assert lm.remat_spans(cfg) == [range(0, 6), range(6, 12),
                                   range(12, 13)]
    _, cfg = configs("microllama-300m")
    assert lm.remat_spans(cfg) == [range(0, 1), range(1, 2)]


# (arch, layers, logit_chunk, JAX's count of the gradient with remat)
COUNT_CASES = [("microllama-300m", None, None, 1_409_286_144),
               ("microllama-300m", None, 16, 1_409_286_144),
               ("gemma3-4b", 7, None, 4_596_957_184),
               ("whisper-small", None, None, 1_831_862_272),
               ("deepseek-moe-16b", None, None, 1_495_269_376)]


@pytest.mark.parametrize("arch,layers,chunk,count", COUNT_CASES,
                         ids=lambda v: str(v))
def test_train_step_flops_equal_jax_remat(arch, layers, chunk, count):
    """The port's ``value_and_grad`` of ``models.loss_fn`` (remat by
    default) counts what ``jax.grad`` of ``loss_fn(..., remat=True)``
    counts.  With a logit chunk that does not divide S - 1 the JAX loss
    pads the last chunk and the port's is ragged: JAX counts the padded
    row's head product more, forward and two backward, as with
    ``remat=False`` (``test_torch_dryrun``).  Without remat both count
    less."""
    jcfg, cfg = configs(arch, layers)
    jb = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    tb = {"tokens": torch.empty((B, S), dtype=torch.int32, device="meta")}
    if cfg.is_encoder_decoder:
        shape = (B, cfg.num_prefix_tokens, cfg.d_model)
        jb["frames"] = jax.ShapeDtypeStruct(shape, jnp.float32)
        tb["frames"] = torch.empty(shape, device="meta")
    kw = {} if cfg.is_encoder_decoder else {"logit_chunk": chunk}
    compiled = jax.jit(jax.grad(
        lambda p, b: jmodels.loss_fn(p, b, jcfg, **kw)[0])).lower(
        jspecs.abstract_params(jcfg), jb).compile()
    jf = hlo_analysis.analyze(compiled.as_text())["flops"]
    counts = {}
    for remat in (True, False):
        with op_analysis.OpCounter() as c:
            value_and_grad(
                lambda p, b: models.loss_fn(p, b, cfg, remat=remat, **kw),
                specs.abstract_params(cfg), tb)
        counts[remat] = c.cost.flops
    pad = 0 if chunk is None else B * cfg.d_model * cfg.vocab_size * 2 * 3
    assert jf == count
    assert jf - counts[True] == pad
    assert counts[False] < counts[True]


FAMILIES = [("microllama-300m", None), ("deepseek-moe-16b", None),
            ("falcon-mamba-7b", None), ("hymba-1.5b", None),
            ("phi-3-vision-4.2b", None), ("gemma3-4b", 7),
            ("whisper-small", None)]


@pytest.mark.parametrize("arch,layers", FAMILIES, ids=lambda v: str(v))
def test_remat_changes_no_value(arch, layers):
    """dense, moe, ssm, hybrid, vlm, gemma3's groups and whisper-small:
    the loss and gradients with remat equal those without bit for bit,
    and JAX's ``loss_fn`` (remat) within tolerance."""
    jcfg, cfg = configs(arch, layers)
    tree = (encdec_tests.np_tree(jcfg, seed=3) if cfg.is_encoder_decoder
            else dense_tests.np_tree(jcfg, seed=3))
    jbatch = jmodels.example_batch(jcfg, 2, 24)
    (jl, _), jg = jax.value_and_grad(
        lambda p, b: jmodels.loss_fn(p, b, jcfg), has_aux=True)(
        jax.tree.map(jnp.asarray, tree), jbatch)
    fam = encdec if cfg.is_encoder_decoder else lm
    flat = fam.param_dict(convert.params_from_numpy(tree, cfg, device="cpu"))
    batch = models.example_batch(cfg, 2, 24, device="cpu")
    got = {remat: value_and_grad(
        lambda p, b: models.loss_fn(p, b, cfg, remat=remat), flat, batch)
        for remat in (True, False)}
    (tl, _, tg), (ul, _, ug) = got[True], got[False]
    assert torch.equal(tl, ul)
    assert tg.keys() == ug.keys()
    assert all(torch.equal(tg[k], ug[k]) for k in tg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    grads = convert.params_to_numpy(fam.from_param_dict(tg, cfg))
    # tree.map needs the same tree on both sides: every leaf is compared
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, np.asarray(w), rtol=1e-4, atol=1e-4 * np.abs(w).max()),
        grads, jg)


def test_no_checkpoint_without_autograd(monkeypatch):
    """Under ``torch.no_grad`` (serving) the layers run as they are:
    ``torch.utils.checkpoint`` is never entered, and the logits are
    those of ``remat=False``."""
    _, cfg = configs("microllama-300m")
    params = models.init_params(cfg, 0, device="cpu")
    tokens = models.example_batch(cfg, 2, 16, device="cpu")["tokens"]
    with torch.no_grad():
        want, _ = lm.forward(params, tokens, cfg, remat=False)

    def refuse(*args, **kwargs):
        raise AssertionError("checkpointed without autograd")

    monkeypatch.setattr(lm, "checkpoint", refuse)
    with torch.no_grad():
        got, _ = lm.forward(params, tokens, cfg)
    assert torch.equal(got, want)


def train_temp_bytes(monkeypatch, remat: bool) -> int:
    """The dry run's train-step temp bytes for a 4-layer reduced
    MicroLlama (B 8, S 256) on a (1, 1) meta mesh."""
    cfg = dataclasses.replace(reduced(get_config("microllama-300m")),
                              num_layers=4)
    monkeypatch.setattr(models, "loss_fn",
                        functools.partial(models.loss_fn, remat=remat))
    try:
        with dryrun.fake_world(1):
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            step, args, policy = dryrun.build_program(
                cfg, InputShape("t", 256, 8, "train"), mesh)
            counter = op_analysis.OpCounter()
            dryrun.trace(counter, step, args, policy)
    finally:
        monkeypatch.undo()
    return counter.temp_bytes


def test_remat_at_least_halves_the_train_steps_temp_bytes(monkeypatch):
    """Without remat every layer's activations live until the backward;
    with it one layer's at a time."""
    with_remat = train_temp_bytes(monkeypatch, True)
    without = train_temp_bytes(monkeypatch, False)
    assert 0 < with_remat <= without / 2, (with_remat, without)
