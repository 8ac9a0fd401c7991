"""The port's dry run and op count, held against the JAX package's.

``repro_torch.launch.op_analysis`` counts the aten ops of one run; the
JAX package parses compiled HLO (``repro.launch.hlo_analysis``).  Both
count FLOPs of the matmul family only, so on the reduced MicroLlama
(2 layers, d 256, 4/2 heads, hd 64, d_ff 512, vocab 1024, f32) the
prefill of B=2, S=64 with last-token logits counts exactly 319,815,680
in both: 301,989,888 for the projections, 16,777,216 for the full S x S
attention and 1,048,576 for the logits.  On a fake (2, 2) mesh the
per-card count is a quarter of that.  The gradient of the loss with
``remat=False`` counts what ``jax.grad`` of ``loss_fn(..., remat=False)``
counts (the default, ``remat=True``, is held to JAX's default in
``test_torch_remat``); with a logit chunk that does not divide S - 1 the
JAX loss pads the last chunk and the port's is ragged, so JAX counts the
padded row's head product more (stated in
``test_train_step_flops_equal_jax_grad``).

Nothing here imports ``repro.launch.dryrun``, which sets a 512-device
``XLA_FLAGS`` at import.  Every test leaves no process group behind.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard
from torch.distributed.tensor.debug import CommDebugMode

from repro import models as jmodels
from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import hlo_analysis
from repro.launch import roofline as jroofline
from repro.launch import specs as jspecs
from repro_torch import models, sharding
from repro_torch.configs import ARCH_REGISTRY, get_config, reduced
from repro_torch.core.diloco import value_and_grad
from repro_torch.launch import dryrun, op_analysis, roofline, specs
from repro_torch.launch import mesh as M
from repro_torch.models import lm
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 64
PREFILL_FLOPS = 319_815_680


@pytest.fixture(autouse=True)
def no_process_group_left():
    yield
    assert not dist.is_initialized()


def jax_cfg():
    return jax_reduced(jax_get_config("microllama-300m"))


def port_cfg():
    return reduced(get_config("microllama-300m"))


def jax_flops(fn, *args) -> float:
    compiled = jax.jit(fn).lower(*args).compile()
    return hlo_analysis.analyze(compiled.as_text())["flops"]


def port_prefill(params, tokens):
    return lm.prefill(lm.from_param_dict(params, port_cfg()), tokens,
                      port_cfg(), S, last_only=True)


def meta_tokens():
    return torch.empty((B, S), dtype=torch.int32, device="meta")


def test_reduced_prefill_flops_equal_jax_exactly():
    jcfg = jax_cfg()
    jf = jax_flops(
        lambda p, t: jmodels.prefill(p, t, jcfg, S, last_only=True),
        jspecs.abstract_params(jcfg), jax.ShapeDtypeStruct((B, S), jnp.int32))
    res = op_analysis.analyze(port_prefill, specs.abstract_params(port_cfg()),
                              meta_tokens())
    assert jf == res["flops"] == PREFILL_FLOPS
    assert res["collective_bytes"] == 0 and res["bytes"] > 0


def test_reduced_prefill_on_a_fake_2x2_mesh_counts_a_quarter():
    with dryrun.fake_world(4):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cuda", (2, 2),
                                mesh_dim_names=("data", "model"))
        params = sharding.param_shardings(specs.abstract_params(port_cfg()),
                                          mesh)
        tokens = specs.prefill_batch_shardings({"tokens": meta_tokens()},
                                               mesh)["tokens"]
        counter = op_analysis.OpCounter()
        with sharding.activation_policy(("data",), model_size=2):
            dryrun.trace(counter, port_prefill, (params, tokens))
    assert counter.cost.flops == PREFILL_FLOPS / 4
    assert counter.cost.collective_bytes > 0
    assert set(counter.cost.per_collective) <= {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all"}


ATTENTION_FLOPS = 16_777_216        # the reduced prefill's S x S products


@pytest.mark.parametrize("model", [4, 8])
def test_attention_splits_over_a_model_axis_wider_than_the_kv_heads(model):
    """The reduced MicroLlama has 4 heads and 2 kv heads.  On a (1, 4)
    mesh a card's share of k is half a head: k and v are repeated to one
    per query head, so the queries stay head-sharded (each card one
    head) and the whole prefill splits evenly.  On a (1, 8) mesh the
    heads cannot split and the query sequence is sharded.  Either way a
    card computes 1/model of the attention's products (``bmm``; every
    projection is an ``mm``), where a gathered query would compute all
    of them."""
    with dryrun.fake_world(model):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cuda", (1, model),
                                mesh_dim_names=("data", "model"))
        params = sharding.param_shardings(specs.abstract_params(port_cfg()),
                                          mesh)
        tokens = specs.prefill_batch_shardings({"tokens": meta_tokens()},
                                               mesh)["tokens"]
        counter = op_analysis.OpCounter()
        with sharding.activation_policy(("data",), model_size=model):
            dryrun.trace(counter, port_prefill, (params, tokens))
    attn = sum(r["flops"] for r in counter.breakdown(len(counter.rows))
               if r["op"].startswith("aten.bmm"))
    assert attn == ATTENTION_FLOPS / model
    if model == 4:
        assert counter.cost.flops == PREFILL_FLOPS / 4


def test_shard_offset_follows_dtensor_chunks():
    """Rank 5 of 8 holds rows 940 .. 1127 of 1500 (chunks of 188), and
    of a dim split over both mesh axes of a (2, 4) mesh, its sixth
    eighth."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=5, world_size=8)
    try:
        mesh = init_device_mesh("cuda", (1, 8),
                                mesh_dim_names=("data", "model"))
        x = sharding.distribute(torch.empty(2, 1500, device="meta"),
                                (None, "model"), mesh)
        assert tuple(x._local_tensor.shape) == (2, 188)
        assert sharding.shard_offset(x, 1) == 940
        assert sharding.shard_offset(x, 0) == 0
        mesh = init_device_mesh("cuda", (2, 4),
                                mesh_dim_names=("data", "model"))
        y = sharding.distribute(torch.empty(64, 3, device="meta"),
                                (("data", "model"), None), mesh)
        assert sharding.shard_offset(y, 0) == 5 * 8
        assert sharding.shard_offset(torch.empty(4), 0) == 0
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("chunk", [None, 16])
def test_train_step_flops_equal_jax_grad(chunk):
    jcfg, tcfg = jax_cfg(), port_cfg()

    def jloss(p, b):
        return jmodels.loss_fn(p, b, jcfg, remat=False, logit_chunk=chunk)[0]

    jf = jax_flops(jax.grad(jloss), jspecs.abstract_params(jcfg),
                   {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)})
    with op_analysis.OpCounter() as c:
        value_and_grad(
            lambda p, b: models.loss_fn(p, b, tcfg, remat=False,
                                        logit_chunk=chunk),
            specs.abstract_params(tcfg), {"tokens": meta_tokens()})
    if chunk is None:
        assert c.cost.flops == jf == 1_157_627_904
    else:
        # JAX pads S - 1 = 63 predicted rows to 64: one more row of the
        # (d, V) head product per sequence, forward and two backward
        pad = B * 1 * tcfg.d_model * tcfg.vocab_size * 2 * 3
        assert jf - c.cost.flops == pad == 3_145_728


def test_a_python_loop_counts_ten_bodies():
    """The counterpart of test_hlo_trip_count_correction: ten 8x8x8
    matmuls and ten 256-byte all-reduces."""
    from torch.distributed import _functional_collectives as funcol
    with dryrun.fake_world(2):
        x = torch.ones(8, 8)
        with op_analysis.OpCounter() as c:
            for _ in range(10):
                x = funcol.all_reduce(x @ x, "sum", dist.group.WORLD)
    assert c.cost.flops == 10 * 2 * 8 * 8 * 8
    assert c.cost.collective_bytes == 10 * 8 * 8 * 4
    assert c.cost.collective_wire_bytes == 2 * 10 * 8 * 8 * 4
    assert c.cost.per_collective == {"all-reduce": 10 * 8 * 8 * 4}


def test_the_all_gather_inside_sharding_propagation_is_counted():
    """x @ w with x and w both sharded over "model": DTensor gathers x
    inside the op.  The counter sees it, as CommDebugMode does, and
    counts the local product (x whole, w's shard)."""
    with dryrun.fake_world(4):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cuda", (2, 2),
                                mesh_dim_names=("data", "model"))
        x = sharding.distribute(torch.empty(8, 16, device="meta"),
                                ("model", None), mesh)
        w = sharding.distribute(torch.empty(16, 32, device="meta"),
                                (None, "model"), mesh)
        assert list(x.placements)[1] == Shard(0)
        with CommDebugMode() as comm:
            x @ w
        with op_analysis.OpCounter() as c:
            y = x @ w
        assert comm.get_total_counts() == 1
        assert tuple(y._local_tensor.shape) == (8, 16)
    assert c.cost.per_collective == {"all-gather": 8 * 16 * 4}
    assert c.cost.flops == 2 * 8 * 16 * 16


def test_bytes_of_views_copies_broadcasts_and_indexed_writes():
    a = torch.empty(64, 32, device="meta")
    with op_analysis.OpCounter() as c:
        a.view(32, 64).transpose(0, 1)               # views are free
    assert c.cost.bytes == 0
    with op_analysis.OpCounter() as c:
        a[:8].copy_(torch.empty(8, 32, device="meta"))
    assert c.cost.bytes == 2 * 8 * 32 * 4            # twice the slice
    with op_analysis.OpCounter() as c:
        a + torch.empty(32, device="meta")           # broadcast operand
    assert c.cost.bytes == (64 * 32 + 32 + 64 * 32) * 4
    idx = torch.empty(8, dtype=torch.long, device="meta")
    with op_analysis.OpCounter() as c:
        a.index_put_((idx,), torch.empty(8, 32, device="meta"))
    assert c.cost.bytes == 2 * 8 * 32 * 4 + 8 * 8


def test_temp_bytes_follow_live_storage():
    x = torch.empty(256, 256, device="meta")         # an argument: not temp
    mb = 256 * 256 * 4
    with op_analysis.OpCounter() as c:
        y = x * 2                                    # +1
        z = y.view(-1)                               # a view: no new bytes
        del y
        w = z + 1                                    # +1: z keeps y alive
        del z
        v = w * 3                                    # y freed first
        assert c.live_bytes == 2 * mb
        del w, v
    assert c.temp_bytes == 2 * mb
    assert c.live_bytes == 0


@pytest.mark.parametrize("arch", sorted(ARCH_REGISTRY))
def test_model_flops_per_chip_equal_jax(arch):
    for shape in JAX_SHAPES:
        for chips, accum in ((256, 1), (512, 4)):
            assert roofline.model_flops_per_chip(arch, shape, chips, accum) \
                == jroofline.model_flops_per_chip(arch, shape, chips, accum)


def test_skip_and_error_records_name_the_op(tmp_path, monkeypatch):
    r = dryrun.run_combo("qwen3-0.6b", "long_500k", out_dir=str(tmp_path))
    assert r["status"] == "skipped" and r["reason"] == "no sub-quadratic path"
    assert r["torch"] == torch.__version__
    assert not list(tmp_path.iterdir())              # a skip saves nothing
    # hybrid prefill traces its scan (one block per layer, trip-scaled),
    # and whisper's prefill writes into a sharded self-attention cache
    for arch in ("hymba-1.5b", "whisper-small"):
        r = dryrun.run_combo(arch, "prefill_32k", out_dir=str(tmp_path))
        assert r["status"] == "ok" and r["flops"] > 0
    # an indexed write into that sharded cache fails, and the record
    # names the op
    monkeypatch.setattr(lm, "write_slot", lambda cache, rows, slot_b, new:
                        cache.__setitem__((rows, slot_b), new))
    r = dryrun.run_combo("whisper-small", "prefill_32k",
                         out_dir=str(tmp_path))
    assert r["status"] == "error" and r["op"] == "aten.index_put_.default"
    saved = json.loads((tmp_path / "whisper-small__prefill_32k__h100_32x8"
                        ".json").read_text())
    assert saved["op"] == r["op"] and saved["torch"] == torch.__version__


def test_a_batch_the_data_axes_do_not_divide_is_skipped(tmp_path):
    """The batch plans are the JAX package's (test_torch_sharding), and
    its lowering refuses a batch that its data axes do not divide:
    prefill_32k's 32 rows over the 2-pod mesh's 64 data cards, or a
    train step whose accumulation leaves 32 rows per microbatch.  Such a
    combo is a skip record that says so, and saves nothing."""
    for shape, accum in (("prefill_32k", 1), ("train_4k", 8)):
        r = dryrun.run_combo("microllama-300m", shape, multi_pod=True,
                             accum=accum, out_dir=str(tmp_path))
        assert r["status"] == "skipped", shape
        assert r["reason"] == ("the reference refuses it: 32 rows over 64 "
                               "data cards")
    assert not list(tmp_path.iterdir())
    cfg = get_config("microllama-300m")
    shapes = dryrun.INPUT_SHAPES
    assert dryrun.skip_reason(cfg, shapes["prefill_32k"]) is None
    assert dryrun.skip_reason(cfg, shapes["train_4k"], True, 4) is None
    assert dryrun.skip_reason(cfg, shapes["decode_32k"], True) is None


def test_decode_combo_and_roofline_rows(tmp_path, capsys):
    r = dryrun.run_combo("microllama-300m", "decode_32k",
                         out_dir=str(tmp_path))
    assert r["status"] == "ok" and r["mesh"] == "h100_32x8"
    assert r["flops"] > 0 and r["collective_wire_bytes"] > 0
    # one card holds 1/32 of the batch's cache and 1/8 of its length,
    # and at least 1/8 of the weights
    cfg = get_config("microllama-300m")
    cache = (cfg.num_layers * 128 * 32768 * cfg.num_kv_heads
             * cfg.resolved_head_dim * 2 * 2)           # k and v, bf16
    weights = cfg.param_count() * 2
    assert cache / 256 + weights / 8 <= r["memory"]["argument_bytes"] \
        <= cache / 256 + weights
    rows = roofline.load_rows(str(tmp_path))
    assert len(rows) == 1
    row = rows[0]
    assert row.compute_s == r["flops"] / M.PEAK_FLOPS
    assert row.memory_s == r["bytes_accessed"] / M.HBM_BW
    assert row.collective_s == r["collective_wire_bytes"] / M.LINK_BW
    assert row.bound_s == max(row.compute_s, row.memory_s, row.collective_s)
    assert row.model_flops == roofline.model_flops_per_chip(
        "microllama-300m", "decode_32k", 256)
    capsys.readouterr()                              # the combo's own line
    roofline.print_table(rows)
    roofline.print_table(rows, markdown=True)
    roofline.print_csv(rows)
    assert capsys.readouterr().out.count("microllama-300m") == 3
    md = tmp_path / "table.md"
    md.write_text("before\n<!-- ROOFLINE_TABLE -->\nafter\n")
    roofline.inject(str(md), str(tmp_path))
    roofline.inject(str(md), str(tmp_path))          # idempotent
    text = md.read_text()
    assert text.count("| microllama-300m | decode_32k |") == 1
    assert text.startswith("before") and text.rstrip().endswith("after")


def test_adloco_outer_reduces_across_pods(tmp_path):
    r = dryrun.run_adloco_outer("microllama-300m", out_dir=str(tmp_path))
    assert r["status"] == "ok" and r["mesh"] == "h100_2x32x8"
    assert r["per_collective"].get("all-reduce", 0) > 0


def test_dryrun_and_roofline_clis_exit_0(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "microllama-300m", "--shape", "prefill_32k", "--out", str(tmp_path),
         "--profile", "--top", "5"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "prefill_32k" in out.stdout and "OK" in out.stdout
    assert "top 5 cost centers" in out.stdout
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--dir",
         str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "microllama-300m" in out.stdout


def test_one_card_programs_count_the_same_on_meta_and_on_tensors():
    """The card check's path on the CPU: on the (1, 1) host mesh the
    dry run's programs take plain tensors; real ones count what meta
    ones count, and the predicted peak covers the arguments."""
    from repro_torch import optim
    from repro_torch.cluster.launch_mp import free_port
    from repro_torch.configs.base import InputShape
    cfg = port_cfg()
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = M.make_host_mesh()
        assert tuple(mesh.mesh.shape) == (1, 1)
        params = lm.param_dict(models.init_params(cfg, 0, device="cpu"))
        gen = torch.Generator().manual_seed(0)
        for shape, args in (
                (InputShape("p", S, B, "prefill"),
                 (params, {"tokens": torch.randint(
                     0, cfg.vocab_size, (B, S), generator=gen,
                     dtype=torch.int32)})),
                (InputShape("t", 16, 4, "train"),
                 (params, optim.adamw(2e-5).init(params),
                  {"tokens": torch.randint(0, cfg.vocab_size, (1, 4, 16),
                                           generator=gen,
                                           dtype=torch.int32)}))):
            step, meta_args, policy = dryrun.build_program(cfg, shape, mesh)
            assert all(t.device.type == "meta" and not sharding.is_sharded(t)
                       for t in op_analysis.tensors(meta_args))
            meta = op_analysis.OpCounter()
            dryrun.trace(meta, step, meta_args, policy)
            real = op_analysis.OpCounter()
            dryrun.trace(real, step, args, policy)
            assert real.cost.flops == meta.cost.flops > 0
            assert real.cost.bytes == meta.cost.bytes
            assert dryrun.local_bytes(meta_args) == dryrun.local_bytes(args)
    finally:
        dist.destroy_process_group()
