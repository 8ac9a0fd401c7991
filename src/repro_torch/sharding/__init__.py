"""Parameter and activation partition rules, as DTensor placements.

Port of ``repro/sharding``.  Rules map a regex on the port's parameter
name (a key of ``lm.param_dict``, such as ``layers.3.attn.q``) to a
spec: a tuple with one entry per tensor dimension, each ``None``
(replicated), a mesh axis name, or a tuple of axis names.  A spec is
what ``PartitionSpec`` is to JAX, without JAX's leading stacked-layer
axis (the port's layers are separate tensors).  ``placements`` turns a
spec into one DTensor placement per mesh dimension.  Conventions
(Megatron-style 1-D tensor parallelism over "model"):

  * projections writing a model-parallel feature dim (q/k/v, gate/up,
    mamba in_proj/dt_w/conv, expert gate/up) shard their LAST axis;
  * projections contracting a model-parallel dim (o, down, expert down,
    mamba out_proj/x_proj) shard their FIRST (or middle, for stacked
    experts) axis, so the product is a partial sum that DTensor reduces;
  * embeddings shard the vocab axis ("model"): the LM head is
    vocab-parallel;
  * norms, scalar vectors and routers are replicated.

The first rule that matches wins.  The MoE rules come before the dense
``gate``/``up``/``down`` rules, so routed experts split d_expert as the
JAX package's comment intends.  The JAX package lists the dense rules
first, so there its routed ``moe.gate``/``moe.up`` shard d_model (the
contraction) and ``moe.down`` the expert axis; the port departs from it
for those three leaves only.
"""
from __future__ import annotations

import contextlib
import contextvars
import re
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate,
                                      Shard, distribute_tensor)
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

Spec = Tuple

# (regex on the parameter name, spec)
_RULES = [
    # embeddings / head
    (r"^embed$", ("model", None)),
    (r"^lm_head$", (None, "model")),
    # self- and cross-attention
    (r"\.x?attn\.[qkv]$", (None, "model")),
    (r"\.x?attn\.o$", ("model", None)),
    (r"\.(q|k)_norm$", (None,)),
    # MoE: experts tensor-parallel on d_expert (uniform across E)
    (r"\.moe\.router$", (None, None)),
    (r"\.moe\.(s_)?(gate|up)$", (None, None, "model")),
    (r"\.moe\.(s_)?down$", (None, "model", None)),
    # dense mlp (swiglu) and the encoder-decoder's gelu mlp
    (r"\.(gate|up)$", (None, "model")),
    (r"\.down$", ("model", None)),
    (r"\.mlp\.up_b$", ("model",)),
    (r"\.mlp\.down_b$", (None,)),
    # mamba
    (r"\.mamba\.(in_proj|conv_w|dt_w)$", (None, "model")),
    (r"\.mamba\.(conv_b|dt_b|D)$", ("model",)),
    (r"\.mamba\.(x_proj|A_log|out_proj)$", ("model", None)),
    # norms
    (r"norm", (None,)),
]


def spec_for_path(name: str, ndim: int) -> Spec:
    """The rule's spec for parameter ``name``, padded or cut to ``ndim``."""
    base: Tuple = ()
    for pat, spec in _RULES:
        if re.search(pat, name):
            base = spec
            break
    parts = list(base)[:ndim]
    return tuple(parts + [None] * (ndim - len(parts)))


def _add_fsdp(spec: Spec, shape, fsdp_size: int, min_size: int = 4096) -> Spec:
    """ZeRO-style sharding: put "data" on the largest still-replicated
    matrix dim that it divides, so optimizer and gradient memory is
    O(params / cards) instead of O(params / model parallelism)."""
    if len(shape) < 2:
        return spec              # vectors: not worth gathering
    parts = list(spec)
    cands = [(shape[i], i) for i in range(len(shape))
             if parts[i] is None and shape[i] % fsdp_size == 0
             and shape[i] >= min_size]
    if not cands:
        return spec
    _, i = max(cands)
    parts[i] = "data"
    return tuple(parts)


def _fix_divisibility(spec: Spec, shape, model_size: int) -> Spec:
    """Drop "model" from a dim it does not divide (whisper's vocab of
    51865, hymba's 32001) and move it to the largest divisible
    still-replicated dim, when there is one."""
    parts = list(spec)
    for i, ax in enumerate(parts):
        if ax == "model" and shape[i] % model_size != 0:
            parts[i] = None
            cands = [(shape[j], j) for j in range(len(shape))
                     if parts[j] is None and shape[j] % model_size == 0
                     and shape[j] >= model_size]
            if cands:
                _, j = max(cands)
                parts[j] = "model"
    return tuple(parts)


def _leaf_spec(name: str, shape, fsdp_size: int, model_size: int) -> Spec:
    spec = _fix_divisibility(spec_for_path(name, len(shape)), shape,
                             model_size)
    if fsdp_size:
        spec = _add_fsdp(spec, shape, fsdp_size)
    return spec


def param_specs(params: Dict[str, torch.Tensor], *, fsdp_size: int = 0,
                model_size: int = 8) -> Dict[str, Spec]:
    """{name: spec} for ``params`` ({name: tensor}).  ``fsdp_size`` > 0
    also shards large matrices over "data"."""
    return {k: _leaf_spec(k, tuple(t.shape), fsdp_size, model_size)
            for k, t in params.items()}


def opt_state_specs(opt_state, *, fsdp_size: int = 0, model_size: int = 8):
    """Specs of an optimizer state: the moments ({name: tensor} under
    "m", "v" or "acc") mirror their parameters; scalars (AdamW's step
    count) are replicated."""
    out = {}
    for key, leaf in opt_state.items():
        if isinstance(leaf, dict):
            out[key] = param_specs(leaf, fsdp_size=fsdp_size,
                                   model_size=model_size)
        else:
            out[key] = (None,) * leaf.dim()
    return out


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis: size} of a ``DeviceMesh``, or of such a dict itself (specs
    can be planned for a mesh that no process group backs)."""
    if isinstance(mesh, dict):
        return mesh
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh_shape(mesh) if a in ("pod", "data"))


def batch_specs(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, Spec]:
    """Shard the batch axis over ("pod", "data"), whichever exist."""
    da = data_axes(mesh)
    return {k: (da,) + (None,) * (t.dim() - 1) for k, t in batch.items()}


def placements(spec: Spec, mesh) -> list:
    """One DTensor placement per mesh dim: ``Shard(i)`` where tensor dim
    i names the axis (alone or in a tuple), else ``Replicate()``."""
    where = {}
    for i, entry in enumerate(spec):
        for ax in ((entry,) if isinstance(entry, str) else entry or ()):
            where[ax] = i
    return [Shard(where[ax]) if ax in where else Replicate()
            for ax in mesh.mesh_dim_names]


def distribute(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """``t`` as a DTensor laid out by ``spec``.  On a mesh of one device
    every placement is a replica, and ``t`` stays a plain tensor."""
    if mesh.size() == 1:
        return t
    return distribute_tensor(t, mesh, placements(spec, mesh))


def zeros(shape, spec, mesh, *, dtype, device) -> torch.Tensor:
    """Zeros of global ``shape`` laid out by ``spec``, each card
    allocating only its own shard (a buffer created sharded, as JAX's
    ``out_shardings`` make it): nothing is sent, and on a mesh of one
    device it is a plain tensor.  ``torch.distributed.tensor.zeros``
    would allocate on the mesh's device type, never on ``meta``."""
    if mesh.size() == 1:
        return torch.zeros(shape, dtype=dtype, device=device)
    places = placements(spec, mesh)
    local, _ = compute_local_shape_and_global_offset(shape, mesh, places)
    return _from_shards(torch.zeros(local, dtype=dtype, device=device),
                        mesh, places, shape)


def shard_tree(tree, specs, mesh):
    """``distribute`` every leaf of a nested dict by the matching spec."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return distribute(tree, specs, mesh)


def mesh_sizes(mesh, fsdp: bool):
    """(FSDP size, model-axis size) that the specs of ``mesh`` take."""
    shape = mesh_shape(mesh)
    return (shape.get("data", 1) if fsdp else 0), shape.get("model", 1)


def param_shardings(params: Dict[str, torch.Tensor], mesh, *,
                    fsdp: bool = False) -> Dict[str, torch.Tensor]:
    """Every parameter distributed over ``mesh`` by ``param_specs``."""
    fsdp_size, model_size = mesh_sizes(mesh, fsdp)
    specs = param_specs(params, fsdp_size=fsdp_size, model_size=model_size)
    return shard_tree(params, specs, mesh)


def opt_state_shardings(opt_state, mesh, *, fsdp: bool = False):
    """Every optimizer-state leaf distributed by ``opt_state_specs``."""
    fsdp_size, model_size = mesh_sizes(mesh, fsdp)
    specs = opt_state_specs(opt_state, fsdp_size=fsdp_size,
                            model_size=model_size)
    return shard_tree(opt_state, specs, mesh)


def is_sharded(x) -> bool:
    """Whether ``x`` is a DTensor (laid out over a mesh)."""
    return isinstance(x, DTensor)


def full(x):
    """The whole of a DTensor ``x`` on every card (gathered), as a plain
    tensor; a plain tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def replicated(x):
    """A DTensor ``x`` replicated over its whole mesh (still a DTensor,
    so gradients flow back to its shards); a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def reduced(x):
    """A DTensor ``x`` with its partial sums reduced (each ``Partial``
    placement made ``Replicate``); anything else as it is."""
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def whole_groups(x, dim: int, groups: int):
    """``x`` before its ``dim`` is split into ``groups`` (heads): a
    DTensor whose shard of ``dim`` is not a whole number of groups (4 kv
    heads over 8 cards) is replicated along it first, since the split
    would cut a group.  Anything else comes back as it is."""
    if not isinstance(x, DTensor):
        return x
    local, size = x._local_tensor.shape[dim], x.shape[dim]
    if local == size or local % (size // groups) == 0:
        return x
    places = [Replicate() if p.is_shard() and getattr(p, "dim", None) == dim
              else p for p in x.placements]
    return x.redistribute(x.device_mesh, places)


def flattenable(x, first: int, last: int):
    """``x`` ready to have its dims ``first`` .. ``last`` flattened into
    one (the heads of attention merged): a DTensor is first replicated
    along the mesh dims that shard one of the later dims, or the first
    unevenly, and its shard made contiguous, since no view flattens
    those and torch 2.11 views the shard as it finds it.  Anything else
    comes back as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh, n = x.device_mesh, 1
    for i, p in enumerate(x.placements):
        if p.is_shard(first):
            n *= mesh.size(i)
    places = [Replicate() if p.is_shard() and (
        first < p.dim <= last or (p.dim == first and x.shape[first] % n))
        else p for p in x.placements]
    if places != list(x.placements):
        x = x.redistribute(mesh, places)
    if not x._local_tensor.is_contiguous():
        # a DTensor is contiguous by its global strides, whatever its
        # shard is: ``contiguous()`` would leave the shard as it is
        x = x.clone(memory_format=torch.contiguous_format)
    return x


def on_shards(fn, *xs, outs=None):
    """``fn`` run on each card's own shards of the DTensors ``xs``; its
    result, of ``xs[0]``'s shape, a DTensor laid out as ``xs[0]``: for
    work that needs nothing of the other cards' shards, such as
    attention within a card's own heads.  ``outs``: for an ``fn`` that
    returns a tuple, one (global shape, layout) per result, the layout
    one placement per mesh dim or dims named as for ``constrain``
    ("batch" over the mesh's data axes, "model" over its model axis,
    whether a policy is active or not).  Gradients flow back to the
    shards; an input replicated along a mesh dim that the result is
    split along gets a partial sum there (each card's share of its
    gradient).  Plain tensors go to ``fn`` as they are."""
    x0 = xs[0]
    if not isinstance(x0, DTensor):
        return fn(*xs)
    mesh = x0.device_mesh
    if outs is None:
        layouts = [(x0.shape, x0.placements)]
    else:
        layouts = [(shape, _layout(dims, mesh)) for shape, dims in outs]
    split = {i for _, places in layouts for i, q in enumerate(places)
             if q.is_shard()}

    def local(x):
        if not isinstance(x, DTensor):
            return x
        return x.to_local(grad_placements=[
            Partial() if q.is_replicate() and i in split else q
            for i, q in enumerate(x.placements)])

    out = fn(*(local(x) for x in xs))
    if outs is None:
        out = (out,)
    res = tuple(_from_shards(o, mesh, places, shape)
                for o, (shape, places) in zip(out, layouts))
    return res[0] if outs is None else res


def _layout(dims, mesh) -> list:
    """``on_shards``' result layout: placements as they are, or named
    dims resolved on ``mesh`` itself."""
    if dims and all(isinstance(d, Placement) for d in dims):
        return list(dims)
    names = mesh.mesh_dim_names
    return placements(tuple(
        data_axes(mesh) or None if d == "batch" else
        ("model" if d == "model" and "model" in names else None)
        for d in dims), mesh)


def _from_shards(local, mesh, places, shape):
    """A DTensor of global ``shape`` laid out by ``places`` whose shard
    on this card is ``local``."""
    shape = tuple(shape)
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(local.contiguous(), mesh, places,
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def shard_offset(x, dim: int) -> int:
    """Global index of this card's first element of ``x`` along ``dim``
    (DTensor's chunks: ceil(size / n) each, the last ones shorter); 0
    for a plain tensor."""
    if not isinstance(x, DTensor):
        return 0
    mesh, coord = x.device_mesh, x.device_mesh.get_coordinate()
    off, size = 0, x.shape[dim]
    for i, p in enumerate(x.placements):
        if p.is_shard() and p.dim == dim:
            chunk = -(-size // mesh.size(i))
            start = min(coord[i] * chunk, size)
            off += start
            size = max(0, min(chunk, size - start))
    return off


class _InGrad(torch.autograd.Function):
    """Identity whose backward passes the gradient through ``fn``."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.fn(grad), None


def _in_grad(x, fn):
    """``x``, its gradient passed through ``fn`` before it reaches the op
    that made ``x``.  A plain tensor, or one that needs no gradient,
    comes back as it is."""
    if not isinstance(x, DTensor) or not x.requires_grad:
        return x
    return _InGrad.apply(x, fn)


def whole_groups_in_grad(x, dim: int, groups: int):
    """``x``, with its gradient made ``whole_groups`` before it reaches
    the view that made ``x`` by merging groups into ``dim`` (that view's
    backward splits ``dim`` again)."""
    return _in_grad(x, lambda g: whole_groups(g, dim, groups))


def splittable_in_grad(x, dim: int, first: int):
    """``x``, with its gradient made ``splittable`` before it reaches the
    view that made ``x`` by flattening (``first``, rest) into ``dim``
    (rows back to sequences: left free, DTensor may split the rows'
    gradient over more cards than ``first`` has)."""
    return _in_grad(x, lambda g: splittable(g, dim, first))


# ------------------------------------------------------------------
# activation sharding policy
#
# Without constraints a sharded weight can make the activations follow
# it: a batch replicated over "data" and full (B, S, d) activations
# reduced after every product (the JAX package saw this on
# falcon-mamba-7b's prefill).  The policy pins activations to
# batch-over-data, so the weights are gathered instead.
# ------------------------------------------------------------------

_ACT_POLICY = contextvars.ContextVar("activation_policy", default=None)


@contextlib.contextmanager
def activation_policy(batch_axes, model_axis: Optional[str] = "model",
                      model_size: int = 0):
    """Enable ``constrain`` inside the model's functions (the dry run
    traces under it; on one card it stays unset and ``constrain`` does
    nothing).  ``model_size`` lets layers decide whether heads can be
    sharded (8 heads on a 16-wide axis cannot)."""
    tok = _ACT_POLICY.set({"batch": tuple(batch_axes), "model": model_axis,
                           "model_size": model_size})
    try:
        yield
    finally:
        _ACT_POLICY.reset(tok)


def policy_model_size() -> int:
    pol = _ACT_POLICY.get()
    return pol["model_size"] if pol else 0


def _policy_spec(dims) -> Spec:
    """The spec of ``dims`` under the active policy: "batch" over its
    batch axes, "model" over its model axis, None replicated."""
    pol = _ACT_POLICY.get()
    spec = []
    for d in dims:
        if d == "batch":
            spec.append(pol["batch"] or None)
        elif d == "model":
            spec.append(pol["model"])
        else:
            spec.append(None)
    return tuple(spec)


class _Constrain(torch.autograd.Function):
    """Redistribution to fixed placements, whose backward redistributes
    the gradient to the same placements (the transpose of JAX's sharding
    constraint).  A dim those placements would shard unevenly (whisper's
    1,500 frames over 8 cards) is gathered in the gradient instead: the
    backward of the view before it would move the uneven shards with an
    all-to-all, whose padded result no view takes."""

    @staticmethod
    def forward(ctx, x, places):
        ctx.places = places
        return x.redistribute(x.device_mesh, places)

    @staticmethod
    def backward(ctx, grad):
        mesh = grad.device_mesh
        places = [Replicate() if p.is_shard() and grad.shape[p.dim]
                  % mesh.size(i) else p for i, p in enumerate(ctx.places)]
        return grad.redistribute(mesh, places), None


def pin_grad(x):
    """``x`` itself, whose gradient is first laid out as ``x`` is (a
    DTensor; a plain tensor is returned as it is).  Before a move
    (``redistribute``) it makes the move's backward start from a
    gradient of the moved layout: a partial sum is then reduced while
    it is still a shard, where DTensor may otherwise gather it over the
    other axes first."""
    if not isinstance(x, DTensor):
        return x
    return _Constrain.apply(x, tuple(x.placements))


def constrain(x, *dims):
    """Redistribute the DTensor ``x`` so that each dim lies as named:
    "batch" over the policy's batch axes, "model" over its model axis,
    None replicated.  Its gradient is laid out the same way, as JAX's
    sharding constraint transposes to the same constraint on the
    cotangent.  Returns ``x`` itself when no policy is active or ``x``
    is a plain tensor."""
    if _ACT_POLICY.get() is None or not isinstance(x, DTensor):
        return x
    return _Constrain.apply(x, tuple(placements(_policy_spec(dims),
                                                x.device_mesh)))


def lay_out(x, *dims):
    """``constrain`` whether a policy is active or not, "batch" and
    "model" resolved on ``x``'s own mesh: for a layout that must hold in
    every mode, the one an op needs in order to run at all
    (``on_shards`` work that reads each card's own channels) or the
    one a decode step, which no policy covers, needs to count alike on
    torch 2.11 and 2.13.  A plain tensor is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    return _Constrain.apply(x, tuple(_layout(dims, x.device_mesh)))


def pin(x, *dims):
    """``x`` laid out as named in every mode (``lay_out``), where GSPMD
    lays out the JAX package's activation so whether its sharding
    constraint is there (the policy) or not (the baseline).  The
    ``constrain`` inside marks that constraint: it moves nothing that
    ``lay_out`` would not."""
    return lay_out(constrain(x, *dims), *dims)


def splittable(x, dim: int, first: int):
    """``x`` ready to have its ``dim`` split into (``first``, rest), as a
    view back from flattened rows: a DTensor is replicated along the
    mesh dims that split ``dim`` beyond what ``first`` divides (rows
    over the data and model axes, 32 sequences over the data axis
    alone), and its shard made contiguous (``flattenable``).  Anything
    else comes back as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh, n, places = x.device_mesh, 1, []
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            n *= mesh.size(i)
            if first % n:
                p = Replicate()
        places.append(p)
    if places != list(x.placements):
        x = x.redistribute(mesh, places)
    return flattenable(x, dim, dim)
