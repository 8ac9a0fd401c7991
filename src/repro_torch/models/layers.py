"""Building blocks of the model families the port runs, in PyTorch.

Port of ``repro/models/layers.py`` for every family the port runs
(attention, SwiGLU MLP, the encoder-decoder's GELU MLP, the
capacity-dispatched MoE block, the Mamba-1 selective SSM), and beyond
it DeepSeek-V2's latent attention (``mla_attention``) and a MoE layer
that holds a share of the experts (``held_experts``): plain
functions on tensors, with a parameter group ``p`` passed as a mapping
(an ``nn.ParameterDict`` or a dict of tensors).  Weights keep the JAX
package's ``(d_in, d_out)`` orientation, so every projection is
``x @ W``.  Shapes use B=batch, S=sequence, d=d_model, H=query heads,
Hk=kv heads, hd=head_dim, di=Mamba inner width, n=SSM state size,
cw=conv width.

A local layer of an interleaved arch (gemma3's 5:1, hymba's 15:1)
attends in query blocks against the keys of its block and the one
before (``sdpa_banded``), where JAX's static layer globality lets it
(``plan_window``); any other windowed layer takes masked full
attention, which computes the same function at S x S scores.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch import spans
from repro_torch.configs.base import DeepseekV2Config, ModelConfig
from repro_torch.sharding import (_from_shards, constrain, data_axes,
                                  flattenable, full, is_sharded, lay_out,
                                  on_shards, pin, pin_grad, reduced,
                                  shard_offset, whole_groups,
                                  whole_groups_in_grad)
from repro_torch.trips import repeated

# A window value meaning "attend to everything" for global layers.
GLOBAL_WINDOW = (2 ** 31 - 1) // 2

# Score given to masked logits before the softmax, as in the JAX package.
NEG_INF = -1e30


# --------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.float32):
    """Normal(0, scale) weights drawn in f32 on ``gen``'s device, then
    cast; ``scale`` defaults to 1/sqrt(fan_in)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


# --------------------------------------------------------------------
# norms / rope / activations
# --------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm in f32 with a ``(1 + w)`` scale, cast back to x's dtype.
    A DTensor ``x`` left a partial sum over a mesh axis is reduced first:
    its square needs it whole anyway, and torch 2.13 would otherwise
    hand on a normed partial sum, whose next product gathers its weight
    (2.11 reduces it, so the two versions would count apart)."""
    dtype = x.dtype
    x = reduced(x).float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions: (...,) int -> cos/sin of shape positions.shape + (hd/2,)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., S, H, hd); cos/sin: (S, hd/2) or broadcastable.  Half-split
    rotation (not interleaved)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def swiglu(x, gate_w, up_w, down_w):
    return decode_product(F.silu(decode_product(x, gate_w))
                          * decode_product(x, up_w), down_w)


def gelu_mlp(x, up_w, up_b, down_w, down_b):
    """The encoder-decoder's MLP.  ``jax.nn.gelu`` defaults to the tanh
    approximation, so this takes it too (torch's default is exact)."""
    return F.gelu(x @ up_w + up_b, approximate="tanh") @ down_w + down_b


# --------------------------------------------------------------------
# attention
# --------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "q": dense_init(gen, (d, cfg.q_dim), dtype=dtype),
        "k": dense_init(gen, (d, cfg.kv_dim), dtype=dtype),
        "v": dense_init(gen, (d, cfg.kv_dim), dtype=dtype),
        "o": dense_init(gen, (cfg.q_dim, d), dtype=dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=gen.device)
    return p


def split_heads(t, heads: int, hd: int):
    """(..., heads * hd) -> (..., heads, hd).  A sharded feature dim whose
    shards would cut a head is gathered first (``sharding.whole_groups``;
    a plain tensor is only reshaped)."""
    t = whole_groups(t, t.dim() - 1, heads)
    return t.reshape(*t.shape[:-1], heads, hd)


def merge_heads(t):
    """(..., heads, hd) -> (..., heads * hd).  A sharded (DTensor) ``t``
    is first laid out so that a view can merge it: a split head_dim, or
    heads split unevenly over the cards (12 over 8), gathered
    (``sharding.flattenable``)."""
    heads = t.shape[-2]
    t = flattenable(t, t.dim() - 2, t.dim() - 1)
    merged = t.reshape(*t.shape[:-2], heads * t.shape[-1])
    # the reshape's backward splits the merged dim into heads again
    return whole_groups_in_grad(merged, merged.dim() - 1, heads)


def out_project(out, w):
    """Attention's output (..., heads, hd) merged and projected by the o
    weight ``w`` (heads * hd, d), the merged features laid out as
    ``w``'s rows (``rows_input``): where attention split the query rows
    instead of the heads, merged features whole on every card would
    have every model card compute all of ``w``'s gradient."""
    return rows_input(merge_heads(out), w) @ w


def rows_input(x, w):
    """``x`` laid out for the product ``x @ w`` where ``w`` splits its
    rows over the model axis: x's last dim split the same way and its
    leading dims lying as the batch, its shard contiguous for the
    product's view (query rows split unevenly, 1,500 frames over 8
    cards, leave one no view takes).  Left whole on every model card,
    x would have each card compute all of w's gradient (torch 2.11
    does, and so does DTensor's propagation with no policy).  Otherwise
    ``x`` comes back as it is."""
    if not splits_over_model(w, 0):
        return x
    rows = None if rows_whole_over_data(x) else "batch"
    # GSPMD lays a row-parallel product's input out as the weight's rows
    # with no constraint too, and its gradient so
    x = pin(x, rows, *(None,) * (x.dim() - 2), "model")
    return flattenable(x, 0, x.dim() - 2)


def splits_over_model(w, dim: int) -> bool:
    """Whether the DTensor ``w`` splits its ``dim`` over the "model" mesh
    axis (False for a plain tensor)."""
    if not is_sharded(w) or "model" not in w.device_mesh.mesh_dim_names:
        return False
    return w.placements[w.device_mesh.mesh_dim_names.index("model")] \
        .is_shard(dim)


def rows_whole_over_data(x) -> bool:
    """Whether the DTensor ``x``'s rows (dim 0) lie whole on every card
    of its mesh's data axes, and those hold more than one card: a decode
    step with fewer rows than the data cards (``long_500k``'s B = 1,
    which the decode plan leaves replicated).  False for a plain
    tensor."""
    if not is_sharded(x):
        return False
    mesh = x.device_mesh
    dims = [mesh.mesh_dim_names.index(a) for a in data_axes(mesh)]
    return (_data_cards(mesh) > 1
            and not any(x.placements[i].is_shard(0) for i in dims))


def _data_cards(mesh) -> int:
    """The number of cards over a mesh's data axes together."""
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                     for a in data_axes(mesh))


# Set by ``decode_over_data`` for the layers of a decode step that GSPMD
# splits over the data axes (``decode_product``).
_OVER_DATA = contextvars.ContextVar("decode_over_data", default=False)


@contextlib.contextmanager
def decode_over_data(on: bool):
    """Within it, ``decode_product`` splits over the data axes."""
    tok = _OVER_DATA.set(on)
    try:
        yield
    finally:
        _OVER_DATA.reset(tok)


# (mesh, its data cards viewed as (outer, inner)): one view at a time,
# for the mesh of the decode step being traced
_DATA_VIEW = [None, None]


def data_view(mesh):
    """The same ranks as ``mesh``, its data cards as two mesh dims
    ("outer", "inner") before "model", the inner one as wide as the
    model axis: DTensor splits only whole mesh dims, and GSPMD splits a
    row-parallel decode product's output over as many data cards as the
    model axis has (8 of hymba-1.5b's 32).  The data axes come before
    "model" in every production mesh, so the ranks keep their order."""
    if _DATA_VIEW[0] is not mesh:
        m = mesh.size(mesh.mesh_dim_names.index("model"))
        view = DeviceMesh(mesh.device_type,
                          mesh.mesh.reshape(_data_cards(mesh) // m, m, m),
                          mesh_dim_names=("outer", "inner", "model"))
        _DATA_VIEW[:] = [mesh, view]
    return _DATA_VIEW[1]


def _on_view(x, view, places):
    """The shard of the DTensor ``x`` as a DTensor of ``view``, laid out
    by ``places`` (the same shard on every rank, by the views' rank
    order)."""
    return _from_shards(x._local_tensor, view, places, x.shape)


def _over_inner_data(x, w):
    """``x @ w`` for a w whose rows split over the model axis, its output
    columns split over the inner data cards of ``data_view`` and made
    whole on every card: [K/m] x [K/m, N/m] per card."""
    mesh, lead = x.device_mesh, (None,) * (x.dim() - 1)
    view = data_view(mesh)
    R = Replicate()
    xv = _on_view(lay_out(x, *lead, "model"), view, [R, R, Shard(x.dim() - 1)])
    wv = _on_view(lay_out(w, "model", None), view,
                  [R, R, Shard(0)]).redistribute(view, [R, Shard(1), Shard(0)])
    y = (xv @ wv).redistribute(view, [R, R, R])
    return _from_shards(y._local_tensor, mesh, [R] * mesh.ndim, y.shape)


def decode_product(x, w):
    """``x @ w`` of a decode step's layer; within ``decode_over_data``
    and where x's rows lie whole on every data card
    (``rows_whole_over_data``), split over the data axes as GSPMD splits
    the JAX package's hymba-1.5b at B = 1: its vocab does not divide the
    model axis, the embedding splits d over it instead, and the residual
    it carries arrives at each product with d split over the model
    axis.  The rule, read from JAX's compiled programs (m the model
    axis's cards, D the data cards):

      * m does not divide D (a (2, 4) mesh): GSPMD gathers x over the
        model axis and runs the plain tensor-parallel products, with
        nothing over the data axes; so does this;
      * w's rows split over the model axis (o, down, out_proj): the
        output's columns split over m of the D data cards, to give the
        residual its d split ([200] x [200, 200] per card for hymba's o
        on (32, 8)).  DTensor splits only whole mesh dims, so the
        product runs on ``data_view``'s inner data dim, and its result,
        a partial sum over "model", is made whole on every card;
      * w's columns split over the model axis, or neither dim (q, k, v,
        gate, up, in_proj): where w's columns per card are fewer than
        x's d, GSPMD moves x's split of d to the data axes and contracts
        over them ([50] x [50, 688] per card for hymba's gate: reducing
        the output over the data cards moves less than gathering x);
        here w's rows lie over the data axes and x's last dim with them,
        and the partial sums over them are reduced after the product.
        Otherwise (d 256 with in_proj's 256 columns per card on a (4, 4)
        mesh) GSPMD gathers x, and this takes ``x @ w``.

    A weight replicated over the data axes gives each card its slice
    with nothing sent.  Outside the scope (a residual whole on every
    card: the vocab divides the model axis, as gemma3-4b's does, and
    GSPMD splits no decode product over the data axes), and for plain
    tensors, ``x @ w``."""
    if not (_OVER_DATA.get() and rows_whole_over_data(x)):
        return x @ w
    mesh = x.device_mesh
    m = mesh.size(mesh.mesh_dim_names.index("model"))
    if _data_cards(mesh) % m:
        return x @ w
    if splits_over_model(w, 0):
        return _over_inner_data(x, w)
    model_cols = splits_over_model(w, 1)
    if w.shape[1] // (m if model_cols else 1) >= x.shape[-1]:
        return x @ w
    lead = (None,) * (x.dim() - 1)
    return reduced(lay_out(x, *lead, "batch")
                   @ lay_out(w, "batch", "model" if model_cols else None))


def channels_over_model(state, dim: int):
    """A decode state with its channels (``dim``) split over the model
    axis only: a DTensor that the long_500k plan spreads over the data
    axes too (falcon-mamba-7b's 8,192 channels over all 256 cards) is
    gathered over them, as GSPMD does before the Mamba step, which it
    runs on the model axis's channels whatever the state's layout (the
    new state is laid back out where the cache is written).  Anything
    else comes back as it is."""
    if not is_sharded(state):
        return state
    mesh, data = state.device_mesh, data_axes(state.device_mesh)
    dim %= state.dim()
    places = [Replicate() if name in data and p.is_shard(dim) else p
              for name, p in zip(mesh.mesh_dim_names, state.placements)]
    if places == list(state.placements):
        return state
    return state.redistribute(mesh, places)


def qkv_project(p, x, cfg: ModelConfig, positions):
    """x (B,S,d) -> q (B,S,H,hd), k,v (B,S,Hk,hd), RoPE applied."""
    hd = cfg.resolved_head_dim
    q = split_heads(x @ p["q"], cfg.num_heads, hd)
    k = split_heads(x @ p["k"], cfg.num_kv_heads, hd)
    v = split_heads(x @ p["v"], cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def sdpa(q, k, v, *, causal: bool, window=None, q_offset: int = 0):
    """Plain scaled-dot-product attention with GQA.

    q/k: (B,S,H or Hk,hd), v: (B,Sk,Hk,hv); the output (B,Sq,H,hv) takes
    v's head width, which MLA makes narrower than q's and k's (the
    scale stays 1/sqrt(hd)).  ``window`` limits attention to the last
    ``window`` keys; None or GLOBAL_WINDOW = full.  The softmax runs in
    f32 and its probabilities are cast to q's dtype before the PV
    product, as in the JAX package.
    """
    B, Sq, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    qg = whole_groups(q, 2, Hk).reshape(B, Sq, Hk, H // Hk, hd)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() * scale
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = _softmax(logits).to(q.dtype)
    out = flattenable(torch.einsum("bkgqs,bskh->bqkgh", probs, v), 2, 3)
    # a DTensor output's gradient laid out as the output (``pin_grad``):
    # left free, its partial sums are reduced or scattered as the torch
    # version pleases, and the backward's products split otherwise
    return whole_groups_in_grad(pin_grad(out.reshape(B, Sq, H, v.shape[-1])),
                                2, Hk)


def _softmax(logits):
    """Softmax over the last dim.  On a DTensor it is written out (max,
    exp, sum): DTensor cannot place ``_softmax_backward_data`` when the
    backward shards the batch over a second mesh axis."""
    if not is_sharded(logits):
        return torch.softmax(logits, dim=-1)
    e = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


def sdpa_banded(q, k, v, *, window: int, q_offset: int = 0, block=None):
    """Causal sliding-window attention in query blocks, the port of the
    JAX package's ``sdpa_banded``: each block of ``block`` query rows
    attends the ``window`` keys before the block and its own, so the
    scores are (B,Hk,G,n,block+window) instead of (B,Hk,G,S,S).  Keys
    before position 0 are a zero-padded phantom, masked out; the
    relative mask is the same for every block.  Exact for any window,
    and equal to ``sdpa(..., causal=True, window=window)``.

    q: (B,n,H,hd), the query rows q_offset .. q_offset+n-1; k/v:
    (B,Sk,Hk,hd), the keys from position 0 through q_offset+n-1 at
    least.  ``block`` defaults to ``window`` (JAX's blocks, two windows
    of keys per row), and n must then be a multiple of it; a card's
    shard of the query rows (``policy_sdpa``) passes gcd(n, window), so
    a shard smaller than a window is one block of its own.  The softmax
    runs in f32 and its probabilities are cast to q's dtype before the
    PV product, as in ``sdpa``.  Plain tensors only (``policy_sdpa``
    runs it on each card's shards)."""
    B, n, H, hd = q.shape
    Hk = k.shape[2]
    block = block or window
    assert n % block == 0, (n, block)
    nb, span = n // block, block + window
    lo = q_offset - window                     # block 0's first key

    def blocks(t):
        # (B, n + window, Hk, hd) keys from lo -> (B, nb, span, Hk, hd)
        t = F.pad(t[:, max(lo, 0):q_offset + n],
                  (0, 0, 0, 0, max(-lo, 0), 0))
        return t.unfold(1, span, block).permute(0, 1, 4, 2, 3)

    qb = q.reshape(B, nb, block, Hk, H // Hk, hd)
    logits = torch.einsum("bnqkgh,bnskh->bnkgqs", qb, blocks(k)).float()
    logits = logits * (1.0 / math.sqrt(hd))
    dev = q.device
    tq = torch.arange(block, device=dev)[:, None]
    tk = torch.arange(span, device=dev)[None, :]
    rel = tk - window - tq                     # key minus query position
    kpos = lo + block * torch.arange(nb, device=dev)[:, None, None] + tk
    mask = (rel <= 0) & (rel > -window) & (kpos >= 0)    # (nb,block,span)
    logits = logits.masked_fill(~mask[None, :, None, None], NEG_INF)
    probs = _softmax(logits).to(q.dtype)
    out = torch.einsum("bnkgqs,bnskh->bnqkgh", probs, blocks(v))
    return out.reshape(B, n, H, hd)


def attention(p, x, cfg: ModelConfig, *, causal=True, window=None,
              positions=None, use_kernel=False, banded=False):
    """Full-sequence attention sublayer (no cache): x (B,S,d) -> (B,S,d).
    ``banded=True`` (a local layer, ``plan_window``) attends in blocks
    (``sdpa_banded``) where the kernel is not asked for."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = qkv_project(p, x, cfg, positions)
    if use_kernel:
        from repro_torch.kernels.flash_attention.ops import flash_attention
        out = flash_attention(q, k, v, causal=causal, window=window)
    else:
        out = policy_sdpa(q, k, v, cfg, causal=causal, window=window,
                          banded=banded)
    return out_project(out, p["o"])


def policy_sdpa(q, k, v, cfg: ModelConfig, *, causal: bool, window=None,
                banded: bool = False):
    """``sdpa`` (``sdpa_banded`` with ``banded``) laid out so that each
    card computes only its share of the scores, as the JAX package's
    sharding policy constrains it and as GSPMD lays it out with no
    policy (the baseline, whisper's decode step) from the projections'
    sharded outputs, the batch over the data axes (``sharding.pin``):

      * heads that split evenly over the model axis are sharded.  Where
        the kv heads do not (4 kv heads over 8 cards), k and v are first
        repeated to one per query head (Megatron's kv replication), so
        that the grouping never gathers the queries;
      * otherwise the query sequence is sharded (context parallelism, as
        the JAX package does for fewer heads than the axis: sharding
        would split the head_dim contraction and reduce the scores).
        A card's banded rows attend in blocks of their own, against
        the keys of the window before them.

    Either way a card's scores need nothing of the other cards, so they
    run on its own shards (``sharding.on_shards``: DTensor's einsum path
    would reach the same products through a sharding search that takes
    hours on the 2-pod mesh, or refuse to flatten the split heads on
    torch 2.11); the output stays laid out so, and ``out_project`` moves
    the merged heads to the o weight's rows.  Fewer query rows than
    model cards (a decode step's token), plain tensors and a mesh
    without a model axis run on the layout they come in.

    Training on the card: where autograd records on plain CUDA bf16
    tensors of hd 64 or 128, causal with no window, attention takes the
    Hopper kernels' forward and backward (``flash_attention.ops.
    takes_train_kernel``, ``flash_attention_train``), never a score
    tensor; other CUDA training calls stay here and are counted
    (``ops.train_plain_calls``).  The CPU and the meta device always
    stay here."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    if flash_ops.takes_train_kernel(q, k, v, causal=causal, window=window):
        return flash_ops.flash_attention_train(q, k, v)
    flash_ops.count_plain_train(q)

    def attend(q, k, v, q_offset=0):
        if banded:
            return sdpa_banded(q, k, v, window=window, q_offset=q_offset,
                               block=math.gcd(q.shape[1], window))
        return sdpa(q, k, v, causal=causal, window=window, q_offset=q_offset)

    m = model_axis_size(q)
    H, Hk = q.shape[2], k.shape[2]
    if not m or (H % m and q.shape[1] < m):
        return attend(q, k, v)
    if H % m:
        q = pin(q, "batch", "model", None, None)
        off = shard_offset(q, 1)
        return on_shards(lambda q, k, v: attend(q, k, v, q_offset=off), q,
                         *(pin(t, "batch", None, None, None) for t in (k, v)))
    if Hk % m:
        k, v = (repeat_kv(pin(t, "batch", None, None, None), H // Hk)
                for t in (k, v))
    heads = ("batch", None, "model", None)
    return on_shards(attend, *(pin(t, *heads) for t in (q, k, v)))


def init_mla(gen: torch.Generator, cfg: DeepseekV2Config, dtype):
    """MLA's weights (``DeepseekV2Config``): q (d, H (nope + rope)),
    kv_a (d, rank + rope), kv_norm (rank,) zeros, kv_b (rank, H (nope +
    v)) and o (H v, d)."""
    d, H, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    return {
        "q": dense_init(gen, (d, H * cfg.qk_head_dim), dtype=dtype),
        "kv_a": dense_init(gen, (d, r + cfg.qk_rope_head_dim), dtype=dtype),
        "kv_norm": torch.zeros((r,), dtype=dtype, device=gen.device),
        "kv_b": dense_init(gen, (r, H * (cfg.qk_nope_head_dim
                                         + cfg.v_head_dim)), dtype=dtype),
        "o": dense_init(gen, (H * cfg.v_head_dim, d), dtype=dtype),
    }


def mla_attention(p, x, cfg: DeepseekV2Config, positions):
    """Multi-head latent attention (DeepSeek-V2), x (B,S,d) -> (B,S,d):
    the latent c = RMSNorm(x Wkv_a's first ``kv_lora_rank`` columns)
    gives each head's k_nope and v through kv_b; the decoupled rope key
    (kv_a's last ``qk_rope_head_dim`` columns) is shared by every head;
    q = x Wq per head as [q_nope ; q_rope]; rotary on the rope parts
    alone; causal attention through ``policy_sdpa`` at q/k width nope +
    rope and v width ``v_head_dim`` (the flash training route takes one
    width only, so this stays plain and is counted); o on the merged
    heads.  Opens the span ``mla`` (``repro_torch.spans``)."""
    B, S, _ = x.shape
    H, r = cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    with spans.span("mla"):
        q = (x @ p["q"]).reshape(B, S, H, dn + dr)
        ckr = x @ p["kv_a"]
        c = rms_norm(ckr[..., :r], p["kv_norm"], cfg.rms_eps)
        kv = (c @ p["kv_b"]).reshape(B, S, H, dn + dv)
        cos, sin = rope_cos_sin(positions, dr, cfg.rope_theta)
        q = torch.cat([q[..., :dn], apply_rope(q[..., dn:], cos, sin)], -1)
        k_r = apply_rope(ckr[..., None, r:], cos, sin).expand(B, S, H, dr)
        k = torch.cat([kv[..., :dn], k_r], -1)
        out = policy_sdpa(q, k, kv[..., dn:], cfg, causal=True)
        return out_project(out, p["o"])


def model_axis_size(x) -> int:
    """The size of the "model" axis of the DTensor ``x``'s mesh; 0 for a
    plain tensor or a mesh without that axis."""
    if not is_sharded(x) or "model" not in x.device_mesh.mesh_dim_names:
        return 0
    return x.device_mesh.size(x.device_mesh.mesh_dim_names.index("model"))


def repeat_kv(t, g: int):
    """(B,S,Hk,hd) -> (B,S,Hk*g,hd), kv head j serving query heads
    j*g .. j*g+g-1 (the grouping of ``sdpa``)."""
    B, S, Hk, hd = t.shape
    rep = t[:, :, :, None, :].expand(B, S, Hk, g, hd).reshape(
        B, S, Hk * g, hd)
    # the reshape's backward splits the heads into (Hk, g) again
    return whole_groups_in_grad(rep, 2, Hk)


def layer_groups(cfg: ModelConfig):
    """(groups, layers per group, tail layers) of a local/global
    interleaved arch (gemma3 5:1), as JAX's ``lm._grouped``; None for a
    uniform one.  JAX runs such an arch's groups in a scan whose body
    unrolls the layers, and its tail layers one by one, each with a
    static globality, which lets their local layers attend in blocks
    (under remat JAX's ``jax.checkpoint`` of a tail layer traces its
    flag, so there JAX's tail attends masked; the port's is banded)."""
    if cfg.global_every is None or cfg.sliding_window is None:
        return None
    g = cfg.global_every
    ng = cfg.num_layers // g
    if ng == 0:
        return None
    return ng, g, cfg.num_layers - ng * g


def plan_window(cfg: ModelConfig, is_global: bool, S: int):
    """(window, banded) of one layer over S positions: window None for
    a global layer (or an arch without sliding windows), else
    ``cfg.sliding_window``; banded (``sdpa_banded``) for a local layer
    of an interleaved arch (``layer_groups``) where S is a multiple of
    the window and at least two of them, JAX's rule.  A windowed arch
    that JAX scans with a traced globality flag takes masked full
    attention, as JAX's does."""
    if is_global or cfg.sliding_window is None:
        return None, False
    w = cfg.sliding_window
    return w, (layer_groups(cfg) is not None and S % w == 0 and S // w >= 2)


def _rope_pos_for_decode(pos):
    """Normalize decode ``pos`` (0-d or (B,) tensor) so rope_cos_sin's
    cos/sin broadcast against (B,1,H,hd) queries."""
    if pos.ndim == 0:
        return pos[None]                 # (1,)   -> cos (1, hd/2)
    return pos[:, None]                  # (B,1)  -> cos (B, 1, hd/2)


def decode_attention(p, x, cfg: ModelConfig, k_cache, v_cache, pos, *,
                     cache_len_valid=None, window=None, kv_pos_of_slot=None):
    """One-token attention against a cache.

    x: (B,1,d); k_cache/v_cache: (B,C,Hk,hd) already holding this
    token's k/v.  ``pos``: absolute position of the new token, a 0-d
    tensor (lockstep batch) or a (B,) tensor (every request at its own
    position).  ``kv_pos_of_slot``: (C,) or (B,C) absolute position held
    by each cache slot; None -> slot i holds position i.  A cache laid
    out over a mesh (a DTensor) is attended on each card's own slots
    and the cards' results combined (``decode_on_shards``).
    """
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q = split_heads(decode_product(x, p["q"]), cfg.num_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
    cos, sin = rope_cos_sin(_rope_pos_for_decode(pos), hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    C = k_cache.shape[1]
    slot_pos = (kv_pos_of_slot if kv_pos_of_slot is not None
                else torch.arange(C, device=x.device))
    Hk = cfg.num_kv_heads
    qg = whole_groups(q, 2, Hk).reshape(B, Hk, cfg.num_heads // Hk, hd)
    if is_sharded(k_cache):
        out = decode_on_shards(qg, k_cache, v_cache, pos, slot_pos,
                               cache_len_valid=cache_len_valid,
                               window=window)
        return decode_product(out.reshape(B, 1, cfg.q_dim), p["o"])
    logits = _decode_logits(qg, k_cache, pos, slot_pos, cache_len_valid,
                            window)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v_cache)
    return out.reshape(B, 1, cfg.q_dim) @ p["o"]


def _decode_logits(qg, k, pos, slot_pos, cache_len_valid, window):
    """f32 scores (B,Hk,g,c) of grouped queries qg (B,Hk,g,hd) against
    the slots k (B,c,Hk,hd) whose absolute positions are ``slot_pos``
    (c,) or (B,c), the slots the token at ``pos`` does not see at
    NEG_INF."""
    B, c = k.shape[:2]
    slot_pos = torch.atleast_2d(slot_pos).expand(B, c)
    pos_b = pos.expand(B)[:, None]                             # (B,1)
    logits = torch.einsum("bkgh,bskh->bkgs", qg, k).float()
    logits = logits * (1.0 / math.sqrt(qg.shape[-1]))
    mask = (slot_pos <= pos_b) & (slot_pos >= 0)
    if cache_len_valid is not None:
        mask &= slot_pos > pos_b - cache_len_valid
    if window is not None:
        mask &= slot_pos > pos_b - window
    return logits.masked_fill(~mask[:, None, None, :], NEG_INF)


def decode_split(qg, k, v, pos, slot_pos, *, cache_len_valid=None,
                 window=None):
    """One split of flash-decoding: grouped queries qg (B,Hk,g,hd)
    against the slots k/v (B,c,Hk,hd) of one slice of the cache, whose
    absolute positions are ``slot_pos`` (c,) or (B,c); masking as in
    ``decode_attention``.  Returns the slice's (max (B,Hk,g) f32, sum of
    exps (B,Hk,g) f32, un-normalised PV product (B,Hk,g,hd) f32);
    ``combine_splits`` joins the slices."""
    logits = _decode_logits(qg, k, pos, slot_pos, cache_len_valid, window)
    m = torch.amax(logits, dim=-1)
    e = torch.exp(logits - m[..., None])
    pv = torch.einsum("bkgs,bskh->bkgh", e.to(qg.dtype), v).float()
    return m, torch.sum(e, dim=-1), pv


def combine_splits(m, l, pv, dtype):
    """Flash-decoding's combine over the last dim of the splits'
    results (``decode_split``'s, stacked: m, l (B,Hk,g,n), pv
    (B,Hk,g,hd,n)): each split rescaled to the overall max, summed, and
    normalised -> (B,Hk,g,hd) in ``dtype``.  A split whose slots are all
    masked has max NEG_INF and weighs exp(NEG_INF - max) = 0."""
    scale = torch.exp(m - torch.amax(m, dim=-1, keepdim=True))
    total = torch.sum(l * scale, dim=-1)
    out = torch.sum(pv * scale[..., None, :], dim=-1)
    return (out / total[..., None]).to(dtype)


def decode_on_shards(qg, k_cache, v_cache, pos, slot_pos, *,
                     cache_len_valid=None, window=None):
    """``decode_attention`` against DTensor caches split along C: each
    card runs ``decode_split`` on its own slots (their positions from
    ``shard_offset``) for all heads of its rows, its results one split
    of a splits dim laid out over the mesh dims that split C, and
    ``combine_splits`` joins them (a max and two sums across those
    cards).  Each card so computes its share of the scores and the PV
    product; a sharded C inside one einsum is what torch 2.11's DTensor
    will not flatten.  Returns (B,Hk,g,hd), rows laid out as the
    cache's, replicated elsewhere."""
    mesh, places = k_cache.device_mesh, list(k_cache.placements)
    B, C = k_cache.shape[:2]
    Hk, g, hd = qg.shape[1:]
    splits = [i for i, q in enumerate(places) if q.is_shard(1)]
    n = math.prod(mesh.size(i) for i in splits)
    # every head of the card's rows, whole
    rows = [Shard(0) if q.is_shard(0) else Replicate() for q in places]
    qg = qg.redistribute(mesh, rows)
    b0, c0 = shard_offset(k_cache, 0), shard_offset(k_cache, 1)

    def split(k, v, qg, pos, slot_pos):
        c = k.shape[1]
        sp = torch.atleast_2d(slot_pos)
        sp = sp[:, c0:c0 + c] if sp.shape[0] == 1 else \
            sp[b0:b0 + k.shape[0], c0:c0 + c]
        pos = pos if pos.dim() == 0 else pos[b0:b0 + k.shape[0]]
        m, l, pv = decode_split(qg, k, v, pos, sp,
                                cache_len_valid=cache_len_valid,
                                window=window)
        return m[..., None], l[..., None], pv[..., None]

    def laid(last: int):
        """Rows as the cache's, the splits dim ``last`` over C's dims."""
        return [Shard(0) if q.is_shard(0) else
                Shard(last) if q.is_shard(1) else Replicate() for q in places]

    m, l, pv = on_shards(split, k_cache, v_cache, qg, pos, slot_pos,
                         outs=[((B, Hk, g, n), laid(3)),
                               ((B, Hk, g, n), laid(3)),
                               ((B, Hk, g, hd, n), laid(4))])
    return combine_splits(m, l, pv, qg.dtype)


def gathered_attention(q, k_cache, v_cache, qpos, kv_pos, *, window=None):
    """Multi-query attention against a gathered (paged) KV cache.

    q: (B,Sq,H,hd) already RoPE'd; k_cache/v_cache: (B,C,Hk,hd) gathered
    from the block pool and already holding the chunk's own k/v; qpos:
    (B,Sq) absolute query positions; kv_pos: (B,C) absolute position held
    by each gathered slot (-1 = unallocated -> masked out).  Masked slots
    score exactly NEG_INF, so they add exactly 0 to the softmax.
    """
    B, Sq, H, hd = q.shape
    Hk = k_cache.shape[2]
    qg = whole_groups(q, 2, Hk).reshape(B, Sq, Hk, H // Hk, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k_cache).float()
    logits = logits * (1.0 / math.sqrt(hd))
    kv = kv_pos[:, None, :]                              # (B,1,C)
    qp = qpos[:, :, None]                                # (B,Sq,1)
    mask = (kv <= qp) & (kv >= 0)                        # (B,Sq,C)
    if window is not None:
        mask &= kv > qp - window
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v_cache)
    return out.reshape(B, Sq, H, hd)


def project_kv_one(p, x, cfg: ModelConfig, pos):
    """k/v for a single new token: x (B,1,d) -> (B,1,Hk,hd) each.
    ``pos``: 0-d or (B,) tensor."""
    hd = cfg.resolved_head_dim
    k = split_heads(decode_product(x, p["k"]), cfg.num_kv_heads, hd)
    v = split_heads(decode_product(x, p["v"]), cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    cos, sin = rope_cos_sin(_rope_pos_for_decode(pos), hd, cfg.rope_theta)
    return apply_rope(k, cos, sin), v


# --------------------------------------------------------------------
# MoE (capacity-based sort dispatch — no (T,E,C) one-hot tensor)
# --------------------------------------------------------------------

# Parameters of a MoE block that stay f32 in a bf16 model, as in the JAX
# init: the router (its logits are f32).
MOE_F32_LEAVES = ("router",)


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype):
    """The router over all E experts; gate, up and down of the experts
    the layer holds (``held_experts``)."""
    mc = cfg.moe
    d, E = cfg.d_model, mc.num_experts
    Eh = len(held_experts(cfg))
    de = mc.d_expert or cfg.d_ff
    p = {
        "router": dense_init(gen, (d, E), dtype=torch.float32),
        "gate": dense_init(gen, (Eh, d, de), dtype=dtype),
        "up": dense_init(gen, (Eh, d, de), dtype=dtype),
        "down": dense_init(gen, (Eh, de, d), dtype=dtype),
    }
    if mc.num_shared:
        ns = mc.num_shared
        p["s_gate"] = dense_init(gen, (ns, d, de), dtype=dtype)
        p["s_up"] = dense_init(gen, (ns, d, de), dtype=dtype)
        p["s_down"] = dense_init(gen, (ns, de, d), dtype=dtype)
    return p


def held_experts(cfg: ModelConfig) -> range:
    """The experts a MoE layer holds: a share of them where the config
    says so (``DeepseekV2Config.experts_held``), else every one (every
    config of the JAX package)."""
    return (cfg.held if isinstance(cfg, DeepseekV2Config)
            else range(cfg.moe.num_experts))


class MoERoute(NamedTuple):
    """The routing of T tokens' T*K assignments (token t's k-th choice
    is assignment t*K + k)."""
    probs: torch.Tensor      # (T, E) f32 router softmax
    topw: torch.Tensor       # (T, K) f32 top-k weights (renormalised
    #                          unless the config says not)
    topi: torch.Tensor       # (T, K) expert of each choice
    capacity: int            # C: slots per expert
    slot: torch.Tensor       # (T*K,) held expert's index * C + rank, or
    #                          (experts held) * C if dropped or not held
    kept: torch.Tensor       # (T*K,) bool: held, and rank < C


def moe_route(p, x, cfg: ModelConfig, *,
              capacity_factor: float = 1.25) -> MoERoute:
    """Route x (T, d): f32 router logits, top-k of the softmax, and each
    assignment's rank within its expert in a STABLE sort by expert id
    (so among one expert's assignments the earlier token ranks first).
    C = max(K, ceil(T*K/E * capacity_factor)) from this call's T.  A
    layer that holds a share of the experts (``held_experts``) routes
    over all E alike, and only its held experts' assignments take a
    slot: each held expert's ranks, and so its drops, are the whole
    layer's."""
    mc = cfg.moe
    T = x.shape[0]
    E, K = mc.num_experts, mc.top_k
    C = max(K, int(math.ceil(T * K / E * capacity_factor)))
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, K, dim=-1)
    if not isinstance(cfg, DeepseekV2Config) or cfg.norm_topk:
        topw = topw / torch.sum(topw, dim=-1, keepdim=True)

    # the stable sort couples every token of the group: a sharded
    # (DTensor) choice tensor is gathered whole first
    topi = full(topi)
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    idx = torch.arange(T * K, device=x.device)
    rank = idx - torch.searchsorted(sorted_e, sorted_e, side="left")
    valid = rank < C
    held = held_experts(cfg)
    valid &= (sorted_e >= held.start) & (sorted_e < held.stop)
    dest = torch.where(valid, (sorted_e - held.start) * C + rank,
                       len(held) * C)
    slot = torch.empty_like(dest)
    slot[order] = dest
    kept = torch.empty_like(valid)
    kept[order] = valid
    return MoERoute(probs, topw, topi, C, slot, kept)


def moe_block(p, x, cfg: ModelConfig, *, capacity_factor: float = 1.25,
              decode: bool = False):
    """MoE with per-group dispatch.  x: (T, d) flattened tokens, or
    (G, Tg, d) grouped tokens (G = batch rows), where every group is
    routed independently (its own capacity) and aux is the groups'
    mean.  ``decode``: x holds the tokens of one decode step (the
    layout of the expert products over a mesh; nothing changes on plain
    tensors).  Returns (y like x, aux_loss f32 scalar)."""
    if x.dim() == 3:
        outs = [_moe_block_flat(p, xg, cfg, capacity_factor=capacity_factor)
                for xg in x]
        return (torch.stack([y for y, _ in outs]),
                torch.mean(torch.stack([a for _, a in outs])))
    return _moe_block_flat(p, x, cfg, capacity_factor=capacity_factor,
                           decode=decode)


# Assignments routed by the layers that hold a share of the experts
# (``held_experts``), counted outside any backward pass, so that a remat
# recompute counts nothing again: ``moe_routed`` all of them (host), and
# on the device those routed to a held expert and those of them kept
# within capacity (``moe_counts`` reads them).
moe_routed = 0
_moe_held_kept: Optional[torch.Tensor] = None


def _count_routes(r: MoERoute, held: range) -> None:
    global moe_routed, _moe_held_kept
    if torch._C._current_graph_task_id() != -1:
        return
    moe_routed += r.topi.numel()
    c = torch.stack([((r.topi >= held.start) & (r.topi < held.stop)).sum(),
                     r.kept.sum()])
    _moe_held_kept = c if _moe_held_kept is None else _moe_held_kept + c


def moe_counts() -> dict:
    """The assignments counted since ``reset_moe_counts``: routed (all),
    held (to a held expert), kept (held, within capacity) and dropped
    (held, over capacity).  Reads the device (a synchronize)."""
    held, kept = ((0, 0) if _moe_held_kept is None
                  else _moe_held_kept.tolist())
    return {"routed": moe_routed, "held": held, "kept": kept,
            "dropped": held - kept}


def reset_moe_counts() -> None:
    global moe_routed, _moe_held_kept
    moe_routed, _moe_held_kept = 0, None


def _moe_block_flat(p, x, cfg: ModelConfig, *,
                    capacity_factor: float = 1.25, decode: bool = False):
    """x: (T, d) -> (y (T, d), aux_loss).  Sort-based capacity dispatch:
    kept assignments are scattered into an (E*C, d) buffer (unused slots
    zero), each expert's SwiGLU runs as one batched product per matrix,
    and each assignment's output comes back weighted by its top-k weight
    (dropped assignments give 0).  Shared experts see every token.  The
    load-balance aux counts every assignment, dropped ones too.  A layer
    that holds a share of the experts (``held_experts``: gate, up and
    down hold those experts alone) has a buffer of their slots only: an
    assignment to an expert it does not hold adds nothing, as one chip
    of an expert-parallel group adds its own experts' part of the result
    with no exchange; the aux still counts all E experts, which every
    chip of the group can do alike."""
    mc = cfg.moe
    T, d = x.shape
    E, K = mc.num_experts, mc.top_k
    r = moe_route(p, x, cfg, capacity_factor=capacity_factor)
    C = r.capacity
    held = held_experts(cfg)
    Eh = len(held)                             # the experts with slots
    if isinstance(cfg, DeepseekV2Config):
        _count_routes(r, held)

    # kept assignments fill their (unique) slots; dropped ones land in
    # an extra slot Eh*C that is cut off (no data-dependent shapes).
    # Unused slots read tokens in turn (a zero contribution), so that the
    # gather's backward adds no long run into one row
    idx = torch.arange(T * K, device=r.slot.device)
    tok = idx // K
    slot_token = torch.arange(Eh * C + 1, device=r.slot.device) % T
    slot_token = slot_token.scatter_(0, r.slot, tok)[:Eh * C]
    slot_used = torch.zeros((Eh * C + 1,), dtype=x.dtype,
                            device=r.slot.device)
    slot_used = slot_used.scatter_(0, r.slot, torch.ones_like(
        r.slot, dtype=x.dtype))[:Eh * C]
    # gathered straight into (E, C): a sharded (E*C, d) would have to be
    # viewed as (E, C, d)
    if decode:
        # a decode step's few slots, on every card, the products split
        # over the data axes along d (the contraction of gate and up,
        # the output of down) and over "model" along the experts' width:
        # an even split for any E and C, laid out here because no policy
        # is open in decode and DTensor's own layout of the gather
        # differs between torch versions
        xe = lay_out(x, None, "batch")[slot_token.reshape(Eh, C)] \
            * slot_used.reshape(Eh, C, 1)
        xe = lay_out(xe, None, None, "batch")
        h = F.silu(lay_out(torch.bmm(xe, p["gate"]), None, None, "model")) \
            * lay_out(torch.bmm(xe, p["up"]), None, None, "model")
        ye = torch.bmm(h, lay_out(p["down"], None, "model", "batch"))
    else:
        xe = x[slot_token.reshape(Eh, C)] * slot_used.reshape(Eh, C, 1)
        # under the sharding policy the capacity slots split over the
        # data axes (each card runs its share of every expert's slots),
        # in the products too: left free, the FSDP shards of the expert
        # weights may decide their layout and leave every slot on every
        # card.  GSPMD splits them so with no constraint, from the
        # batch-sharded tokens: laid out in every mode, the slots and
        # each product's result, gradients with them (torch 2.11 left
        # the FSDP-sharded contraction split and every slot on every
        # data card, grok-1-314b's train step 7.3x the policy's)
        slots, hidden = (None, "batch", None), (None, "batch", "model")
        xe = pin(xe, *slots)
        h = F.silu(pin(torch.bmm(xe, p["gate"]), *hidden)) \
            * pin(torch.bmm(xe, p["up"]), *hidden)
        ye = pin(torch.bmm(h, p["down"]), *slots)

    w = r.topw.reshape(-1, 1).to(x.dtype) * r.kept.to(x.dtype)[:, None]
    # an assignment not kept (dropped, or to an expert held elsewhere:
    # most of them in a held share) has weight 0 and reads the slots in
    # turn, not one shared slot, whose gradient the backward would add
    # up row after row.  One index into the flat (E*C, d) view gathers in
    # half the time of (expert, slot) index pairs; a sharded ye keeps the
    # pairs, as its flat view adds work to the split step (the dry run's
    # even split of a train step)
    s = torch.where(r.kept, r.slot, idx % (Eh * C))
    ys = (ye[s // C, s % C] if is_sharded(ye)
          else ye.reshape(Eh * C, d)[s])
    y = (ys * w).reshape(T, K, d).sum(dim=1)

    # load-balance aux loss (Switch-style).  Taken before the shared
    # experts, so that a recompute in the backward (``lm.run_layers``)
    # stops before their down products, whose outputs it never reads
    flat_e = r.topi.reshape(-1)
    counts = torch.zeros((E,), dtype=torch.long, device=flat_e.device)
    counts = counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    frac_tokens = counts.float() / (T * K)
    mean_prob = torch.mean(r.probs, dim=0)
    aux = mc.load_balance_coef * E * torch.sum(frac_tokens * mean_prob)

    # the shared experts, one SwiGLU each: JAX's einsums over the stacked
    # (s, d, f) weights as 2-D products, which DTensor shards as the
    # dense MLP's (torch 2.11 cannot flatten the sharded f in the einsum)
    for i in range(mc.num_shared):
        y = y + swiglu(x, p["s_gate"][i], p["s_up"][i], p["s_down"][i])
    return y, aux


# --------------------------------------------------------------------
# Mamba-1 selective SSM
# --------------------------------------------------------------------

# Parameters of a Mamba block that stay f32 in a bf16 model, as in the
# JAX init: the dt bias, A_log and the skip weight D.
MAMBA_F32_LEAVES = ("dt_b", "A_log", "D")


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype):
    ssm = cfg.ssm
    d, di, n, dtr = cfg.d_model, cfg.d_inner, ssm.state_dim, cfg.dt_rank
    dev, f32 = gen.device, torch.float32
    # S4D-real A init: A[:, j] = -(j+1); dt drawn log-uniform in
    # [1e-3, 1e-1] and stored through the inverse softplus
    A = torch.arange(1, n + 1, dtype=f32, device=dev)[None, :].repeat(di, 1)
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((di,), generator=gen, device=dev, dtype=f32)
    dt_bias = torch.log(torch.expm1(torch.exp(lo + (hi - lo) * u)))
    return {
        "in_proj": dense_init(gen, (d, 2 * di), dtype=dtype),
        "conv_w": dense_init(gen, (ssm.conv_dim, di), scale=0.5, dtype=dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, (di, dtr + 2 * n), dtype=dtype),
        "dt_w": dense_init(gen, (dtr, di), dtype=dtype),
        "dt_b": dt_bias,
        "A_log": torch.log(A),
        "D": torch.ones((di,), dtype=f32, device=dev),
        "out_proj": dense_init(gen, (di, d), dtype=dtype),
    }


def causal_conv1d(x, w, b, prev=None):
    """Depthwise causal conv: x (B,S,di), w (cw,di) -> (B,S,di).

    ``prev``: (B,cw-1,di) raw inputs preceding x (the carried conv state
    of chunked prefill); None = zeros (sequence start).  The taps are
    unrolled and summed in x's dtype, as in JAX (``F.conv1d`` would
    accumulate a bf16 input in f32).  Sharded (DTensor) inputs convolve
    each card's own batch rows and channels (``sharding.on_shards``):
    the taps run along the sequence, which no card splits."""
    chans = ("batch", None, "model")
    return on_shards(
        _conv1d, lay_out(x, *chans), lay_out(w, None, "model"),
        lay_out(b, "model"), None if prev is None else lay_out(prev, *chans))


def _conv1d(x, w, b, prev):
    cw = w.shape[0]
    if prev is None:
        xp = F.pad(x, (0, 0, cw - 1, 0))
    else:
        xp = torch.cat([prev.to(x.dtype), x], dim=1)
    S = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(cw):
        out = out + xp[:, i:i + S] * w[i][None, None]
    return out + b[None, None]


def conv_state(x_in, cw: int):
    """The decode conv state after a sequence: its last cw-1 raw inputs
    (B, cw-1, di), left-padded with zeros when the sequence is shorter.
    (JAX's one-shot prefill slices ``x_in[:, -(cw-1):]``, which is short
    for a 1- or 2-token prompt; its chunked path pads, as here.)"""
    S = x_in.shape[1]
    if S >= cw - 1:
        return x_in[:, S - (cw - 1):].clone()
    return F.pad(x_in, (0, 0, cw - 1, 0))[:, -(cw - 1):]


def scan_blocks(u, S: int, sub: int):
    """(lo, hi) of each block of ``sub`` steps over a sequence of S, the
    last one ragged.  Meta tensors hold no values, so their full blocks
    all trace alike: the first stands for every one of them, inside
    ``trips.repeated`` (an ``OpCounter`` counts it S // sub times),
    then the ragged tail.  Tensors with values run every block."""
    full = S // sub
    if u.device.type == "meta" and full > 1:
        with repeated(full):
            yield 0, sub
        if S > full * sub:
            yield full * sub, S
        return
    for lo in range(0, S, sub):
        yield lo, min(lo + sub, S)


def ssm_scan_seq(u, dt, A_log, Bmat, Cmat, sub: int = 16, h0=None):
    """Selective scan as a sequential recurrence, forward only.

    h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t,  y_t = <h_t, C_t>, with
    A = -exp(A_log) and h in f32 throughout, from ``h0`` (B,di,n) or
    zeros.  Shapes as in ``ssm_scan_chunked``.  Per block of ``sub``
    steps the decays exp(dt A) and injections dt u B are formed at once
    (the same elementwise values JAX's unrolled steps compute), then
    each step is one fused multiply-add on the (B,di,n) state; y
    follows from the block's states.  The state buffer is written with
    ``out=``, so no input may need a gradient (training uses
    ``ssm_scan_chunked``).  Returns y (B,S,di) and h_last (B,di,n), both
    in u's dtype.
    """
    return _scan_on_shards(
        lambda u, dt, A_log, Bmat, Cmat, h0: _scan_seq(
            u, dt, A_log, Bmat, Cmat, sub=sub, h0=h0),
        u, dt, A_log, Bmat, Cmat, h0)


def _scan_on_shards(scan, u, dt, A_log, Bmat, Cmat, h0=None):
    """``scan(u, dt, A_log, Bmat, Cmat, h0)`` -> (y, h_last); sharded
    (DTensor) inputs scan each card's own batch rows and channels
    (``sharding.on_shards``), the recurrence running along the sequence,
    which no card splits."""
    Bsz, _, di = u.shape
    chans = ("batch", None, "model")
    return on_shards(
        scan, lay_out(u, *chans), lay_out(dt, *chans),
        lay_out(A_log, "model", None), lay_out(Bmat, "batch", None, None),
        lay_out(Cmat, "batch", None, None),
        None if h0 is None else lay_out(h0, "batch", "model", None),
        outs=[(u.shape, chans),
              ((Bsz, di, A_log.shape[1]), ("batch", "model", None))])


def _scan_seq(u, dt, A_log, Bmat, Cmat, *, sub: int, h0):
    Bsz, S, di = u.shape
    n = A_log.shape[1]
    negA = -torch.exp(A_log.float())                      # (di,n)
    h = (torch.zeros((Bsz, di, n), dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    y = torch.empty((Bsz, S, di), dtype=torch.float32, device=u.device)
    hs = torch.empty((sub, Bsz, di, n), dtype=torch.float32, device=u.device)
    for lo, hi in scan_blocks(u, S, sub):
        dtf = dt[:, lo:hi].float()
        duf = dtf * u[:, lo:hi].float()                   # (B,s,di)
        a = torch.exp(dtf[..., None] * negA)              # (B,s,di,n)
        x = duf[..., None] * Bmat[:, lo:hi, None, :].float()
        a, x = a.transpose(0, 1), x.transpose(0, 1)       # (s,B,di,n)
        for t in range(hi - lo):
            h = torch.addcmul(x[t], a[t], h, out=hs[t])
        y[:, lo:hi] = torch.einsum("sbdn,bsn->bsd", hs[:hi - lo],
                                   Cmat[:, lo:hi].float())
        # freed before the next block's: every block peaks alike, so
        # the one block traced on meta tensors gives the loop's peak
        del dtf, duf, a, x
    # h is a view of the step buffer: hand back a tensor of its own
    return y.to(u.dtype), h.to(u.dtype, copy=True)


def _assoc_scan(a, b):
    """Inclusive scan along axis 1 of the affine maps h -> a h + b with
    JAX's ``combine``: (a_l, b_l) then (a_r, b_r) gives
    (a_l a_r, b_r + a_r b_l).  Hillis-Steele, log2(len) out-of-place
    passes, so autograd differentiates it."""
    c = a.shape[1]
    off = 1
    while off < c:
        a_prev = F.pad(a[:, :c - off], (0, 0, 0, 0, off, 0), value=1.0)
        b_prev = F.pad(b[:, :c - off], (0, 0, 0, 0, off, 0))
        b = b + a * b_prev
        a = a * a_prev
        off *= 2
    return a, b


def ssm_scan_chunked(u, dt, A_log, Bmat, Cmat, chunk: int = 256):
    """Selective scan h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t,
    y_t = <C_t, h_t>, A = -exp(A_log).

    u, dt: (B,S,di); Bmat, Cmat: (B,S,n); A_log: (di,n).  A loop over
    chunks of ``chunk`` steps carries the f32 state; inside a chunk a
    log-depth associative scan (differentiable, the training path).  A
    ragged last chunk is shorter instead of padded.  Returns y (B,S,di)
    and the final state (B,di,n), both in u's dtype.
    """
    return _scan_on_shards(
        lambda u, dt, A_log, Bmat, Cmat, h0: _scan_chunked(
            u, dt, A_log, Bmat, Cmat, chunk=chunk),
        u, dt, A_log, Bmat, Cmat)


def _scan_chunked(u, dt, A_log, Bmat, Cmat, *, chunk: int):
    Bsz, S, di = u.shape
    n = A_log.shape[1]
    negA = -torch.exp(A_log.float())
    h0 = torch.zeros((Bsz, di, n), dtype=torch.float32, device=u.device)
    ys = []
    for lo in range(0, S, chunk):
        hi = min(lo + chunk, S)
        dtf = dt[:, lo:hi].float()
        a = torch.exp(dtf[..., None] * negA)                # (B,c,di,n)
        x_in = ((dtf * u[:, lo:hi].float())[..., None]
                * Bmat[:, lo:hi].float()[:, :, None, :])    # (B,c,di,n)
        a_sc, x_sc = _assoc_scan(a, x_in)
        h = a_sc * h0[:, None] + x_sc
        ys.append(torch.einsum("bcdn,bcn->bcd", h,
                               Cmat[:, lo:hi].float()).to(u.dtype))
        h0 = h[:, -1]
    return torch.cat(ys, dim=1), h0.to(u.dtype)


def _in_proj(x, w):
    """(x_in, z), the two halves of ``x @ w``.  A DTensor ``w`` (columns
    over the model axis) is cut into its halves before the product, each
    half's columns then spread over every card: the product's halves
    would each lie on half the cards, a layout DTensor's pad (the conv)
    cannot take on torch 2.11.  Each half's gradient is reduced over
    the data axes while it is still laid out like the half, then
    gathered (``pin_grad``), the transpose of the forward's gather."""
    if not is_sharded(w):
        return torch.chunk(x @ w, 2, dim=-1)
    mesh, places = w.device_mesh, list(w.placements)
    whole = w.redistribute(mesh, [Replicate() if q.is_shard(1) else q
                                  for q in places])
    di = w.shape[1] // 2
    return tuple(constrain(x @ pin_grad(half.redistribute(mesh, places)),
                           "batch", None, "model")
                 for half in (whole[:, :di], whole[:, di:]))


def _mamba_in(p, x, cfg: ModelConfig, prev=None):
    """The shared front of a Mamba block: (x_in, z, x_c, dt, Bm, Cm)."""
    n, dtr = cfg.ssm.state_dim, cfg.dt_rank
    x_in, z = _in_proj(x, p["in_proj"])
    x_c = F.silu(causal_conv1d(x_in, p["conv_w"], p["conv_b"], prev=prev))
    # x_proj contracts the model-sharded channels: reduced here (with no
    # policy too: torch 2.11 cannot add dt_b's shard to a partial sum),
    # so that dt_w's product splits its channels instead of gathering
    # dt_w, and laid out so in every mode: GSPMD reduces dt_r's gradient,
    # a partial sum over the model axis from dt_w's product, before
    # x_proj's backward; left a partial sum, it gathers x_c and x_proj
    # on every model card
    dt_r, Bm, Cm = torch.split(pin(reduced(x_c @ p["x_proj"]),
                                   "batch", None, None),
                               [dtr, n, n], dim=-1)
    dt = F.softplus((dt_r @ p["dt_w"]).float()
                    + p["dt_b"][None, None]).to(x.dtype)
    return x_in, z, x_c, dt, Bm, Cm


def _mamba_out(p, x, y, x_c, z):
    y = y + x_c * p["D"][None, None].to(x.dtype)
    return (y * F.silu(z)) @ p["out_proj"]


def mamba_forward(p, x, cfg: ModelConfig, *, use_kernel=False,
                  return_state=False, scan_impl: str = "assoc"):
    """Full-sequence Mamba block: x (B,S,d) -> (B,S,d).

    ``use_kernel`` routes the scan through
    ``kernels.mamba_scan.ops.mamba_scan`` (the hand-written kernel on a
    CUDA tensor, its plain version on a CPU tensor); otherwise
    ``scan_impl`` picks ``"seq"`` (``ssm_scan_seq``, prefill) or
    ``"assoc"`` (``ssm_scan_chunked``, the JAX default).
    ``return_state=True`` also returns the decode state {"conv":
    (B,cw-1,di) raw conv inputs, "ssm": (B,di,n)} from the same scan."""
    x_in, z, x_c, dt, Bm, Cm = _mamba_in(p, x, cfg)
    if use_kernel:
        from repro_torch.kernels.mamba_scan.ops import mamba_scan
        y, h_last = mamba_scan(x_c, dt, p["A_log"], Bm, Cm)
    elif scan_impl == "seq":
        y, h_last = ssm_scan_seq(x_c, dt, p["A_log"], Bm, Cm)
    elif scan_impl == "assoc":
        y, h_last = ssm_scan_chunked(x_c, dt, p["A_log"], Bm, Cm)
    else:
        raise ValueError(f"scan_impl={scan_impl!r}: 'seq' or 'assoc'")
    out = _mamba_out(p, x, y, x_c, z)
    if return_state:
        return out, {"conv": conv_state(x_in, cfg.ssm.conv_dim),
                     "ssm": h_last}
    return out


def mamba_decode(p, x, cfg: ModelConfig, conv_state, ssm_state):
    """One-token Mamba step.

    x: (B,1,d); conv_state: (B,cw-1,di) previous raw inputs; ssm_state:
    (B,di,n).  Returns (y (B,1,d), new conv state, new ssm state).  The
    casts are JAX's: (dt x_c) B is formed in the model dtype and then
    cast to f32, and y contracts the state cast back to the model dtype
    with C in the model dtype."""
    n, dtr = cfg.ssm.state_dim, cfg.dt_rank
    conv_state = channels_over_model(conv_state, -1)
    ssm_state = channels_over_model(ssm_state, 1)
    x_in, z = torch.chunk(decode_product(x[:, 0], p["in_proj"]), 2,
                          dim=-1)                                # (B,di)
    window = torch.cat([conv_state, x_in[:, None]], dim=1)       # (B,cw,di)
    x_c = torch.einsum("bcd,cd->bd", window, p["conv_w"]) + p["conv_b"][None]
    x_c = F.silu(x_c)
    # x_proj contracts the channels: its partial sums over a sharded di
    # reduced here, as ``_mamba_in`` does, or dt_w's product and y's
    # would each run over every channel on every card
    xp = _channel_product(torch.matmul, x_c, p["x_proj"], ("model", None),
                          (x_c.shape[0], p["x_proj"].shape[1]), partial=True)
    dt_r, Bm, Cm = torch.split(reduced(xp), [dtr, n, n], dim=-1)
    dt = F.softplus((dt_r @ p["dt_w"]).float()
                    + p["dt_b"][None]).to(x.dtype)
    a = torch.exp(dt[..., None] * (-torch.exp(p["A_log"]))[None])  # (B,di,n)
    h = (a * ssm_state.float()
         + ((dt * x_c)[..., None] * Bm[:, None, :]).float())
    y = _channel_product(lambda u, c: torch.einsum("bdn,bn->bd", u, c),
                         h.to(x.dtype), Cm, (None, None), h.shape[:2])
    y = y + x_c * p["D"][None].to(x.dtype)
    out = decode_product(y * F.silu(z), p["out_proj"])
    return out[:, None], window[:, 1:], h.to(ssm_state.dtype)


def _channel_product(fn, a, b, b_dims, shape, partial: bool = False):
    """``fn(a, b)`` of a decode step's Mamba block, ``a`` a (B, di, ...)
    split over the model axis on its channels, ``b`` laid out as
    ``b_dims``, the result of global ``shape``.  Where the rows lie
    whole on every data card (the B = 1 plan), it runs on each card's
    own shards, as GSPMD runs it (x_proj's [1024] x [1024, 288] per card
    for falcon-mamba-7b): DTensor would split it over the data axes too,
    since a replica's further split sends nothing.  ``partial``: ``fn``
    contracts the channels, and its result is a partial sum over the
    model axis; otherwise it keeps them, split as ``a``'s."""
    if not rows_whole_over_data(a):
        return fn(a, b)
    on_model = Partial() if partial else Shard(1)
    places = [on_model if name == "model" else Replicate()
              for name in a.device_mesh.mesh_dim_names]
    return on_shards(lambda u, v: (fn(u, v),),
                     lay_out(a, None, "model", *(None,) * (a.dim() - 2)),
                     lay_out(b, *b_dims), outs=[(shape, places)])[0]


def mamba_forward_chunk(p, x, cfg: ModelConfig, conv_state, ssm_state):
    """``mamba_forward`` continued from a carried decode state: the
    chunked-prefill path.

    x: (B,S,d) chunk; conv_state: (B,cw-1,di) raw conv inputs before
    the chunk; ssm_state: (B,di,n).  Runs ``ssm_scan_seq`` from
    ``h0=ssm_state``, as JAX does (its Pallas scan takes no initial
    state).  Returns (out (B,S,d), {"conv", "ssm"} as in
    ``mamba_forward(return_state=True)``)."""
    cw = cfg.ssm.conv_dim
    x_in, z, x_c, dt, Bm, Cm = _mamba_in(p, x, cfg, prev=conv_state)
    y, h_last = ssm_scan_seq(x_c, dt, p["A_log"], Bm, Cm, h0=ssm_state)
    out = _mamba_out(p, x, y, x_c, z)
    new_conv = torch.cat([conv_state.to(x_in.dtype), x_in],
                         dim=1)[:, -(cw - 1):]
    return out, {"conv": new_conv, "ssm": h_last}
