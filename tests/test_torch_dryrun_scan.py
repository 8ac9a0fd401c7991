"""The dry run's SSM and hybrid prefill, whisper-small's prefill and the
train step's gradient layout, held against the JAX package and against
the port's own full runs.

Prefill's sequential scan runs S / 16 blocks per layer.  On meta tensors
``layers.scan_blocks`` traces one full block inside
``trips.repeated`` and the counter adds it once per block, the
counterpart of ``hlo_analysis`` scaling a while body by its trip count.
On the reduced falcon-mamba-7b and hymba-1.5b (2 layers, d 256, di 512,
n 8) the prefill of B=2, S=64 counts exactly what JAX's compiled HLO
counts: 217,055,232 and 535,822,336 FLOPs.  At a ragged S = 72 JAX pads
the scan to 80 steps and counts the 8 padded steps' <h, C> products
(262,144 FLOPs); the port runs a ragged last block, so only S = 64 is
held to JAX, and both lengths to the full loop.

Nothing here imports ``repro.launch.dryrun``, which sets a 512-device
``XLA_FLAGS`` at import.  Every test leaves no process group behind.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch.distributed import _functional_collectives as funcol
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro import models as jmodels
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import hlo_analysis
from repro.launch import specs as jspecs
from repro_torch import models, sharding, trips
from repro_torch.cluster.launch_mp import free_port
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun, op_analysis, specs
from repro_torch.launch import mesh as M
from repro_torch.models import layers as L
from repro_torch.models import lm
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)

B = 2
JAX_PREFILL_FLOPS = {"falcon-mamba-7b": 217_055_232,
                     "hymba-1.5b": 535_822_336}


@pytest.fixture(autouse=True)
def no_process_group_left():
    yield
    assert not dist.is_initialized()


def port_prefill(cfg, S):
    def step(params, tokens):
        return lm.prefill(lm.from_param_dict(params, cfg), tokens, cfg, S,
                          last_only=True)
    return step


def fake_mesh(shape=(2, 2)):
    return init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))


@pytest.mark.parametrize("arch", sorted(JAX_PREFILL_FLOPS))
def test_ssm_prefill_flops_equal_jax_exactly(arch):
    S = 64
    jcfg, cfg = jax_reduced(jax_get_config(arch)), reduced(get_config(arch))
    compiled = jax.jit(
        lambda p, t: jmodels.prefill(p, t, jcfg, S, last_only=True)).lower(
            jspecs.abstract_params(jcfg),
            jax.ShapeDtypeStruct((B, S), jnp.int32)).compile()
    jf = hlo_analysis.analyze(compiled.as_text())["flops"]
    with op_analysis.OpCounter() as c:
        port_prefill(cfg, S)(specs.abstract_params(cfg),
                             torch.empty((B, S), dtype=torch.int32,
                                         device="meta"))
    assert jf == c.cost.flops == JAX_PREFILL_FLOPS[arch]
    # one traced block of 16 steps stood for all four
    steps = sum(r["count"] for (_, op), r in c.rows.items()
                if op.startswith("aten.addcmul"))
    assert steps == cfg.num_layers * S


@pytest.mark.parametrize("S", [64, 72])
@pytest.mark.parametrize("arch", sorted(JAX_PREFILL_FLOPS))
def test_trip_scaled_count_equals_the_full_loop(arch, S):
    """The same prefill on meta tensors (one block traced per layer,
    then the ragged tail) and on CPU tensors (every block run)."""
    cfg = reduced(get_config(arch))
    params = lm.param_dict(models.init_params(cfg, 0, device="cpu"))
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(0),
                           dtype=torch.int32)
    step = port_prefill(cfg, S)
    with op_analysis.OpCounter() as meta:
        step(specs.abstract_params(cfg),
             torch.empty((B, S), dtype=torch.int32, device="meta"))
    with op_analysis.OpCounter() as real:
        step(params, tokens)
    assert meta.cost.flops == real.cost.flops > 0
    assert meta.cost.bytes == real.cost.bytes
    assert meta.cost.collective_bytes == real.cost.collective_bytes
    assert meta.cost.per_collective == real.cost.per_collective
    assert meta.temp_bytes == real.temp_bytes


def test_scan_blocks_shortcut_only_on_meta():
    real = torch.empty(1)
    assert list(L.scan_blocks(real, 40, 16)) == [(0, 16), (16, 32), (32, 40)]
    meta = torch.empty(1, device="meta")
    assert list(L.scan_blocks(meta, 40, 16)) == [(0, 16), (32, 40)]
    assert list(L.scan_blocks(meta, 48, 16)) == [(0, 16)]
    assert list(L.scan_blocks(meta, 10, 16)) == [(0, 10)]


def test_repeated_scales_flops_bytes_and_collectives_not_temp():
    """The counterpart of test_hlo_trip_count_correction: one 8x8x8
    matmul and one 256-byte all-reduce traced, counted ten times; the
    peak of live bytes is one trip's."""
    with dryrun.fake_world(2):
        x = torch.ones(8, 8)
        with op_analysis.OpCounter() as once:
            funcol.all_reduce(x @ x, "sum", dist.group.WORLD)
        with op_analysis.OpCounter() as c:
            with trips.repeated(10):
                funcol.all_reduce(x @ x, "sum", dist.group.WORLD)
    assert c.cost.flops == 10 * once.cost.flops == 10 * 2 * 8 * 8 * 8
    assert c.cost.bytes == 10 * once.cost.bytes
    assert c.cost.per_collective == {"all-reduce": 10 * 8 * 8 * 4}
    assert c.cost.collective_wire_bytes == 2 * 10 * 8 * 8 * 4
    assert c.temp_bytes == once.temp_bytes > 0
    assert all(r["count"] == 10 for r in c.rows.values())


@pytest.mark.parametrize("arch", sorted(JAX_PREFILL_FLOPS))
def test_ssm_prefill_on_a_fake_2x2_mesh_counts_a_quarter(arch):
    """The scan runs on each card's own batch rows and channels
    (``sharding.on_shards``), and its state comes back laid out as the
    decode plan's (B over data, di over model)."""
    S, cfg = 64, reduced(get_config(arch))
    with op_analysis.OpCounter() as whole:
        port_prefill(cfg, S)(specs.abstract_params(cfg),
                             torch.empty((B * 2, S), dtype=torch.int32,
                                         device="meta"))
    with dryrun.fake_world(4):
        step, args, policy = dryrun.build_program(
            cfg, InputShape("p", S, B * 2, "prefill"), fake_mesh())
        counter = op_analysis.OpCounter()
        _, cache = dryrun.trace(counter, step, args, policy)
        assert list(cache["ssm"].placements) == [Shard(1), Shard(2)]
    assert counter.cost.flops == whole.cost.flops / 4


def test_whisper_prefill_on_a_fake_2x2_mesh_writes_a_sharded_cache():
    cfg = reduced(get_config("whisper-small"))
    with dryrun.fake_world(4):
        step, args, policy = dryrun.build_program(
            cfg, InputShape("p", 64, 4, "prefill"), fake_mesh())
        counter = op_analysis.OpCounter()
        logits, cache = dryrun.trace(counter, step, args, policy)
        for name in ("k", "v"):                      # B over data, C over model
            assert list(cache[name].placements) == [Shard(1), Shard(2)]
            assert tuple(cache[name]._local_tensor.shape) == (
                cfg.num_layers, 2, 32, cfg.num_kv_heads,
                cfg.resolved_head_dim)
        for name in ("xk", "xv"):
            assert list(cache[name].placements) == [Shard(1), Replicate()]
        assert tuple(logits.shape) == (4, cfg.vocab_size)
    assert counter.cost.flops > 0 and counter.cost.collective_bytes > 0


def test_whisper_prefill_step_on_one_card_equals_init_cache_and_decode():
    """On the (1, 1) host mesh the dry run's encoder-decoder prefill
    takes plain tensors and computes what serving computes."""
    cfg = reduced(get_config("whisper-small"))
    params = models.init_params(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    frames = torch.randn((2, cfg.num_prefix_tokens, cfg.d_model),
                         generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        step = dryrun.make_prefill_step(cfg, InputShape("p", 16, 2,
                                                        "prefill"),
                                        M.make_host_mesh())
        logits, cache = step(lm.param_dict(params),
                             {"tokens": tokens, "frames": frames})
    finally:
        dist.destroy_process_group()
    ref_cache = models.init_cache(cfg, params, 2, 16, frames=frames)
    ref_logits, ref_cache = models.decode_step(params, ref_cache,
                                               tokens[:, 0], 0, cfg)
    assert torch.equal(logits, ref_logits)
    assert cache.keys() == ref_cache.keys()
    assert all(torch.equal(cache[k], ref_cache[k]) for k in cache)


def test_constrain_is_identity_without_a_policy_or_a_dtensor():
    t = torch.ones(4, 3)
    with sharding.activation_policy(("data",), model_size=2):
        assert sharding.constrain(t, "batch", None) is t
    with dryrun.fake_world(4):
        x = sharding.distribute(torch.empty(4, 6, device="meta"),
                                (None, "model"), fake_mesh())
        assert sharding.constrain(x, "batch", None) is x


@pytest.mark.parametrize("arch", ["microllama-300m", "qwen3-0.6b",
                                  "falcon-mamba-7b", "hymba-1.5b",
                                  "deepseek-moe-16b"])
def test_train_step_splits_evenly_and_gradients_keep_the_constraint(
        arch, monkeypatch):
    """On a fake (2, 2) mesh the reduced train step's per-card FLOPs are
    exactly the unsharded step's over 4: every constrained activation's
    gradient is laid out as the activation (JAX's transpose rule), so no
    backward product gathers what the forward kept sharded.  The MoE
    router (d, E) is replicated, so both model cards compute its logits
    for the card's data rows: one router product per layer above the
    even split, run twice (in the forward, and again where the backward
    recomputes the layer: the loss rematerialises each layer)."""
    cfg = reduced(get_config(arch))
    shape = InputShape("t", 64, 8, "train")
    step, opt = dryrun.make_train_step(cfg, 1)
    p = specs.abstract_params(cfg)
    with op_analysis.OpCounter() as whole:
        step(p, opt.init(p), specs.train_inputs(cfg, shape))

    seen = []
    backward = sharding._Constrain.backward

    def record(ctx, grad):
        out, _ = backward(ctx, grad)
        seen.append((tuple(grad.placements), tuple(out.placements),
                     tuple(ctx.places)))
        return out, None

    monkeypatch.setattr(sharding._Constrain, "backward",
                        staticmethod(record))
    with dryrun.fake_world(4):
        step, args, policy = dryrun.build_program(cfg, shape, fake_mesh())
        counter = op_analysis.OpCounter()
        dryrun.trace(counter, step, args, policy)
    gap = 0
    if cfg.moe is not None:
        rows = 8 // 2 * 64                 # a data shard's tokens
        gap = 2 * cfg.num_layers * 2 * rows * cfg.d_model \
            * cfg.moe.num_experts * (1 - 1 / 2)
    assert counter.cost.flops - whole.cost.flops / 4 == gap
    assert seen and all(out == places for _, out, places in seen)
    # the constraint did work: a partial-sum gradient came in reduced
    assert any(inc != out for inc, out, _ in seen)


def test_the_gradient_of_an_uneven_constraint_is_gathered():
    """Whisper's 1,500 encoder frames over 8 model cards: the gradient's
    frame dim is gathered, not sharded unevenly."""
    with dryrun.fake_world(8):
        mesh = init_device_mesh("cuda", (1, 8),
                                mesh_dim_names=("data", "model"))
        x = sharding.distribute(torch.empty(2, 1500, 16, device="meta"),
                                (None, None, None), mesh).requires_grad_()
        with sharding.activation_policy(("data",), model_size=8):
            y = sharding.constrain(x, "batch", "model", None)
        assert list(y.placements) == [Shard(0), Shard(1)]
        g = sharding.distribute(torch.empty(2, 1500, 16, device="meta"),
                                (None, "model", None), mesh)
        (gx,) = torch.autograd.grad(y, x, g)
        assert list(gx.placements) == [Shard(0), Replicate()]
        assert isinstance(gx, DTensor)


def test_on_shards_gives_replicated_inputs_a_partial_gradient():
    """Attention's query rows split over the model axis while k and v
    are whole on every card: each card's share of k's gradient is a
    partial sum, which DTensor then reduces."""
    with dryrun.fake_world(4):
        mesh = fake_mesh()
        q = sharding.distribute(torch.empty(2, 8, 4, device="meta"),
                                ("data", "model", None), mesh)
        k = sharding.distribute(torch.empty(2, 8, 4, device="meta"),
                                ("data", None, None), mesh)
        q.requires_grad_(), k.requires_grad_()
        out = sharding.on_shards(lambda q, k: q * k.sum(1, keepdim=True),
                                 q, k)
        assert list(out.placements) == list(q.placements)
        gq, gk = torch.autograd.grad(out, (q, k), torch.ones_like(out))
        assert list(gq.placements) == [Shard(0), Shard(1)]
        assert gk.placements[1].is_partial()


def _move_backward_collectives(pin: bool) -> dict:
    """The collectives of the backward of in_proj's move on a fake (2, 2)
    mesh: a (8, 16) weight whose columns split over "model" is gathered,
    its first half taken and split again, and multiplied by rows split
    over "data"."""
    with dryrun.fake_world(4):
        mesh = fake_mesh()
        w = sharding.distribute(torch.empty(8, 16, device="meta"),
                                (None, "model"), mesh).requires_grad_()
        x = sharding.distribute(torch.empty(4, 8, device="meta"),
                                ("data", None), mesh)
        places = list(w.placements)
        whole = w.redistribute(mesh, [Replicate(), Replicate()])
        half = whole[:, :8].redistribute(mesh, places)
        y = x @ (sharding.pin_grad(half) if pin else half)
        g = sharding.distribute(torch.empty(4, 8, device="meta"),
                                ("data", "model"), mesh)
        with op_analysis.OpCounter() as c:
            (gw,) = torch.autograd.grad(y, w, g)
        assert list(gw.placements) == places
    return c.cost.per_collective


def test_pin_grad_reduces_a_partial_gradient_while_it_is_a_shard():
    """The half's gradient is a partial sum over "data" with its columns
    split over "model".  Pinned, it is all-reduced as the card's (8, 4)
    shard and then gathered; left to DTensor, the move's backward gathers
    it first and all-reduces the whole (8, 8) half."""
    pinned, free = (_move_backward_collectives(True),
                    _move_backward_collectives(False))
    assert pinned == {"all-reduce": 8 * 4 * 4, "all-gather": 8 * 8 * 4}
    assert free["all-reduce"] == 8 * 8 * 4
    t = torch.ones(3)
    assert sharding.pin_grad(t) is t


def test_dtensor_decomposition_tracing_is_not_counted():
    """DTensor has no sharding rule for softplus's backward and derives
    one by running its decomposition on meta tensors of the global shape,
    the first time a process meets it (then it caches the result).  The
    count is the card's work alone: the same on the first meeting as on
    the next, every op at the shard's shape.  (The first decomposition
    of a process also builds DTensor's one-device helper mesh, three
    host scalars that are counted; a warm-up run builds it here.)"""
    prop = DTensor._op_dispatcher.sharding_propagator
    with dryrun.fake_world(4):
        mesh = fake_mesh()

        def count(cold: bool):
            if cold:
                prop.propagate_op_sharding.cache_clear()
            x = sharding.distribute(torch.empty(8, 16, device="meta"),
                                    ("data", "model"), mesh)
            x.requires_grad_()
            y = torch.nn.functional.softplus(x)
            with op_analysis.OpCounter() as c:
                torch.autograd.grad(y, x, torch.ones_like(y))
            return c

        count(True)
        first, again = count(True), count(False)
    assert first.cost.bytes == again.cost.bytes > 0
    assert first.rows.keys() == again.rows.keys()
    assert not any("[8,16]" in op for _, op in first.rows)
