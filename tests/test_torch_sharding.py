"""The port's sharding plans, held against the JAX package's.

``repro_torch.sharding`` names the port's parameters (``layers.3.attn.q``)
where the JAX rules name pytree paths (``['layers']['attn']['q']``, with
a leading stacked-layer axis that the port does not have).  For every
architecture, at model-axis sizes 8 and 16 and FSDP sizes 0, 16 and 32,
every port leaf's spec equals JAX's ``param_specs`` with the leading
``None`` dropped, except the routed experts' ``moe.gate``/``up``/``down``:
the JAX rules list the dense ``gate``/``up``/``down`` first, so they never
reach the MoE rules, and the port orders them the other way
(``test_routed_expert_specs_differ_from_jax_as_stated``).

The batch and decode plans equal JAX's ``specs.*_shardings`` on an
``AbstractMesh`` (no devices) at (16, 16), (32, 8) and (2, 32, 8), and
the meta inputs equal JAX's abstract ones in shape and dtype.  Nothing
here imports ``repro.launch.dryrun``, which sets a 512-device
``XLA_FLAGS`` at import.
"""
import re

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro import sharding as jshard
from repro.configs import ARCH_REGISTRY as JAX_ARCHS
from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import LONG_CONTEXT_ARCHS
from repro.launch import specs as jspecs
from repro_torch import optim, sharding
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import dryrun, specs
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)

ARCHS = sorted(JAX_ARCHS)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "32x8": ((32, 8), ("data", "model")),
          "2x32x8": ((2, 32, 8), ("pod", "data", "model"))}
ROUTED = re.compile(r"\.moe\.(gate|up|down)$")
_STACKED = re.compile(r"^(layers|enc_layers|dec_layers)\.\d+\.")

_jax_params = {}


def jax_params(arch):
    if arch not in _jax_params:
        _jax_params[arch] = jspecs.abstract_params(JAX_ARCHS[arch])
    return _jax_params[arch]


def norm(spec):
    """A spec as a tuple of entries, each None, an axis name, or a tuple
    of two or more names (JAX writes ('data',) as 'data')."""
    out = []
    for e in spec:
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = None if not e else (e[0] if len(e) == 1 else e)
        out.append(e)
    return tuple(out)


def jax_path(name):
    """'layers.3.attn.q' -> ("['layers']['attn']['q']", stacked)."""
    stacked = bool(_STACKED.match(name))
    parts = [p for p in name.split(".") if not p.isdigit()]
    return "".join(f"['{p}']" for p in parts), stacked


def jax_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): leaf for p, leaf in flat}


def port_vs_jax(arch, fsdp_size, model_size):
    """{port name: (port spec, JAX spec without the layer axis)}."""
    jp = jax_params(arch)
    jspec = jax_flat(jshard.param_specs(jp, fsdp_size=fsdp_size,
                                        model_size=model_size))
    tp = specs.abstract_params(get_config(arch))
    tspec = sharding.param_specs(tp, fsdp_size=fsdp_size,
                                 model_size=model_size)
    out = {}
    for name, spec in tspec.items():
        path, stacked = jax_path(name)
        js = norm(jspec[path])
        out[name] = (norm(spec), js[1:] if stacked else js)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch):
    n_checked = 0
    for model_size in (8, 16):
        for fsdp_size in (0, 16, 32):
            for name, (ts, js) in port_vs_jax(arch, fsdp_size,
                                              model_size).items():
                if ROUTED.search(name):
                    continue
                assert ts == js, (name, model_size, fsdp_size)
                n_checked += 1
    assert n_checked > 0


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "grok-1-314b"])
def test_routed_expert_specs_differ_from_jax_as_stated(arch):
    """The rule each package applies to a routed expert leaf (without
    the layer axis): the port splits d_expert (the MoE rules), JAX's
    dense rules split d_model for gate/up and the expert axis for down."""
    tp = specs.abstract_params(get_config(arch))
    routed = [n for n in tp if ROUTED.search(n)]
    assert routed
    port_rule = {"gate": (None, None, "model"), "up": (None, None, "model"),
                 "down": (None, "model", None)}
    jax_rule = {"gate": (None, "model", None), "up": (None, "model", None),
                "down": ("model", None, None)}
    for name in routed:
        leaf = name.rsplit(".", 1)[1]
        assert sharding.spec_for_path(name, 3) == port_rule[leaf]
        path, _ = jax_path(name)
        assert norm(jshard.spec_for_path(path, 4))[1:] == jax_rule[leaf]
        assert port_rule[leaf] != jax_rule[leaf]
    # the shared experts follow the MoE rules in both packages
    cmp = port_vs_jax(arch, 0, 16)
    for name, (ts, js) in cmp.items():
        if re.search(r"\.moe\.s_(gate|up|down)$", name):
            assert ts == js


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_decode_plans_equal_jax(mesh):
    sizes, names = MESHES[mesh]
    jmesh = AbstractMesh(sizes, names)
    tmesh = dict(zip(names, sizes))
    for arch in ARCHS:
        jcfg, tcfg = JAX_ARCHS[arch], get_config(arch)
        for sname, jshape in JAX_SHAPES.items():
            tshape = INPUT_SHAPES[sname]
            if jshape.kind == "train":
                jb = jspecs.train_inputs(jcfg, jshape)
                js = jspecs.train_batch_shardings(jb, jmesh)
                ts = specs.train_batch_specs(
                    specs.train_inputs(tcfg, tshape), tmesh)
                assert {k: norm(v) for k, v in ts.items()} == \
                    {k: norm(v.spec) for k, v in js.items()}, (arch, sname)
            elif jshape.kind == "prefill":
                jb = jspecs.prefill_inputs(jcfg, jshape)
                js = jspecs.prefill_batch_shardings(jb, jmesh)
                ts = specs.prefill_batch_specs(
                    specs.prefill_inputs(tcfg, tshape), tmesh)
                assert {k: norm(v) for k, v in ts.items()} == \
                    {k: norm(v.spec) for k, v in js.items()}, (arch, sname)
            else:
                if sname == "long_500k" and arch not in LONG_CONTEXT_ARCHS \
                        and jcfg.arch_type != "ssm":
                    continue
                jt, jp, jc = jspecs.decode_shardings(jcfg, jshape, jmesh)
                tt, tp, tc = specs.decode_specs(tcfg, tshape, tmesh)
                assert norm(tt) == norm(jt.spec), (arch, sname)
                assert norm(tp) == norm(jp.spec)
                assert {k: norm(v) for k, v in tc.items()} == \
                    {k: norm(v.spec) for k, v in jc.items()}, (arch, sname)


def _same(tt: torch.Tensor, ja) -> bool:
    return (tuple(tt.shape) == tuple(ja.shape)
            and str(tt.dtype).replace("torch.", "") == str(ja.dtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_inputs_equal_jax(arch):
    jflat = jax_flat(jax_params(arch))
    tp = specs.abstract_params(get_config(arch))
    assert all(t.device.type == "meta" for t in tp.values())
    count = {}
    for name, t in tp.items():
        path, stacked = jax_path(name)
        ja = jflat[path]
        jshape = ja.shape[1:] if stacked else ja.shape
        assert tuple(t.shape) == tuple(jshape), name
        assert str(t.dtype).replace("torch.", "") == str(ja.dtype), name
        n, _ = count.get(path, (0, stacked))
        count[path] = (n + 1, stacked)
    assert set(count) == set(jflat)
    for path, (n, stacked) in count.items():   # every layer of a stack
        assert n == (jflat[path].shape[0] if stacked else 1), path
    jcfg, tcfg = JAX_ARCHS[arch], get_config(arch)
    for sname, jshape in JAX_SHAPES.items():
        tshape = INPUT_SHAPES[sname]
        if jshape.kind == "train":
            pairs = [(specs.train_inputs(tcfg, tshape, 4),
                      jspecs.train_inputs(jcfg, jshape, 4))]
        elif jshape.kind == "prefill":
            pairs = [(specs.prefill_inputs(tcfg, tshape),
                      jspecs.prefill_inputs(jcfg, jshape))]
        else:
            if sname == "long_500k" and arch not in LONG_CONTEXT_ARCHS \
                    and jcfg.arch_type != "ssm":
                with pytest.raises(ValueError):
                    specs.cache_len_for(tcfg, tshape)
                continue
            td, jd = (specs.decode_inputs(tcfg, tshape),
                      jspecs.decode_inputs(jcfg, jshape))
            pairs = [(td["cache"], jd["cache"]),
                     ({"token": td["token"], "pos": td["pos"]},
                      {"token": jd["token"], "pos": jd["pos"]})]
        for tb, jb in pairs:
            assert set(tb) == set(jb)
            for k in tb:
                assert _same(tb[k], jb[k]), (arch, sname, k)


def test_abstract_params_match_the_ports_init():
    """Names, shapes and dtypes of a real init (reduced width: the
    Mamba and router leaves stay f32 in a bf16 model)."""
    from repro_torch import models
    from repro_torch.configs import reduced
    for arch in ("hymba-1.5b", "deepseek-moe-16b", "whisper-small"):
        cfg = reduced(get_config(arch)).with_overrides(dtype="bfloat16")
        real = models.lm.param_dict(models.init_params(cfg, 0, device="cpu"))
        meta = specs.abstract_params(cfg)
        assert list(meta) == list(real)
        for k in real:
            assert (meta[k].shape, meta[k].dtype) == (real[k].shape,
                                                      real[k].dtype), k
        if arch != "whisper-small":
            assert any(t.dtype == torch.float32 for t in meta.values())


def test_placements_constrain_and_whole_groups_on_a_fake_mesh():
    from torch.distributed.tensor import Replicate, Shard
    with dryrun.fake_world(4):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cuda", (2, 2),
                                mesh_dim_names=("data", "model"))
        assert sharding.placements((("data", "model"), None), mesh) == \
            [Shard(0), Shard(0)]
        assert sharding.placements((None, "model"), mesh) == \
            [Replicate(), Shard(1)]
        assert sharding.placements(("data",), mesh) == [Shard(0), Replicate()]
        x = sharding.distribute(torch.empty(8, 6, device="meta"),
                                ("data", "model"), mesh)
        assert tuple(x._local_tensor.shape) == (4, 3)
        # no policy: constrain hands its argument back
        assert sharding.constrain(x, "batch", None) is x
        with sharding.activation_policy(("data",), model_size=2):
            y = sharding.constrain(x, "batch", None)
            assert list(y.placements) == [Shard(0), Replicate()]
            assert sharding.policy_model_size() == 2
        assert sharding.policy_model_size() == 0
        # 6 features = 3 heads of 2: a 2-way shard would cut a head
        z = sharding.whole_groups(x, 1, 3)
        assert list(z.placements) == [Shard(0), Replicate()]
        assert sharding.whole_groups(x, 1, 2) is x
        # a plain tensor passes through every helper
        p = torch.ones(2, 2)
        assert sharding.whole_groups(p, 1, 3) is p
        assert sharding.full(p) is p
        # optimizer state: moments follow their params, the count is
        # replicated
        st = optim.adamw(2e-5).init({"layers.0.attn.q": torch.empty(
            8, 16, device="meta")})
        assert st["m"]["layers.0.attn.q"].dtype == torch.float32
        sp = sharding.opt_state_specs(st, model_size=2)
        assert sp == {"m": {"layers.0.attn.q": (None, "model")},
                      "v": {"layers.0.attn.q": (None, "model")}, "t": ()}
    assert not dist.is_initialized()


def test_production_mesh_shape_and_constants():
    from repro_torch.cluster import node
    from repro_torch.launch import mesh as M
    assert M.PRODUCTION_SHAPE == (32, 8) and M.MULTI_POD_SHAPE == (2, 32, 8)
    assert (M.PEAK_FLOPS, M.HBM_BW, M.LINK_BW) == (
        node.PEAK_FLOPS, node.HBM_BW, node.LINK_BW)
    assert M.mesh_name() == "h100_32x8"
    assert M.mesh_name(True) == "h100_2x32x8"
    with dryrun.fake_world(256):
        mesh = M.make_production_mesh()
        assert dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)) == \
            {"data": 32, "model": 8}
        assert M.data_axes(mesh) == ("data",)
    with dryrun.fake_world(512):
        mesh = M.make_production_mesh(multi_pod=True)
        assert M.data_axes(mesh) == ("pod", "data")
        assert np.prod(mesh.mesh.shape) == 512
    assert not dist.is_initialized()
