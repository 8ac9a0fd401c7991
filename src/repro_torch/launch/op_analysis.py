"""Per-card cost of one traced step, counted over its aten ops.

The counterpart of ``repro/launch/hlo_analysis.py``.  PyTorch has no
compiled program text to parse, so ``OpCounter`` (a
``TorchDispatchMode``) counts the ops that one run of the step
dispatches, on meta tensors (the dry run) or on the card.  Its
definitions:

  * FLOPs: the matmul family only (``mm``, ``bmm``, ``addmm``,
    ``baddbmm``, ``linear``, ``mv``, ``dot``, and what ``matmul`` and
    ``einsum`` decompose to): 2 * |result| * |contracted|.  This is the
    JAX package's ``dot``-only definition, so neither package counts
    convolutions or elementwise ops.
  * Bytes: eager PyTorch does not fuse, so every op is one unit of
    device-memory traffic: its tensor operands (a broadcast operand at
    the size it is stored) plus its result.  Views and metadata ops are
    free.  A copy into a view reads the source and writes the view; an
    indexed write (``index_put_``, ``scatter_``, ``index_copy_``, ...)
    reads its update and writes that many bytes.  These bytes are never
    compared with XLA's, which come from fused programs.
  * Collectives: the payload (result bytes) of every all-gather,
    reduce-scatter, all-reduce and all-to-all, and the wire bytes of a
    ring (twice the payload for an all-reduce), per kind.
  * Per card: under DTensor the mode returns ``NotImplemented`` for an
    op with a DTensor operand, so DTensor runs first and the mode sees
    what it then dispatches: the local op at the shard's shapes and the
    collectives its sharding propagation issues.  The ops that DTensor
    runs under a ``FakeTensorMode`` to infer global shapes are not
    counted, nor are the ops of the decomposition through which it
    derives the sharding of an op it has no rule for.
  * Memory: the peak of the bytes held by storages that the step
    allocated (``temp_bytes``), from their creation to the moment the
    last tensor on them dies.  The step's arguments are not in it.

A Python loop over layers runs every layer, so it needs no trip count.
Prefill's sequential scan is the exception: 2,048 blocks per layer at
32,768 tokens, where JAX traces one ``lax.scan`` body and
``hlo_analysis`` scales it by the loop's trip count.  On meta tensors,
whose blocks all trace alike, the scan runs one full block inside
``repro_torch.trips.repeated(n)`` (``models.layers.scan_blocks``), and
the counter adds what it counts there n times: FLOPs, bytes and
collectives, not ``temp_bytes``, a peak.  A kernel of the port
launched through ``ctypes`` is not an aten op and is not seen; the dry
run's programs launch none.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

from repro_torch.trips import trips as _trips

_WIRE_FACTOR = {"all-reduce": 2.0}

# ops that move no data (allocation without a write, metadata, plumbing
# of the functional collectives)
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "_unsafe_view", "_local_scalar_dense", "wait_tensor",
         "_wrap_tensor_autograd", "sym_size", "sym_stride", "sym_numel",
         "set_", "resize_", "is_same_size"}
# indexed writes: they move their update, not the buffer they write into
_INDEXED_WRITES = {"index_put_", "_index_put_impl_", "index_copy_",
                   "scatter_", "scatter_add_", "index_add_"}
_MATMULS = {"mm", "bmm", "addmm", "baddbmm", "mv", "dot", "linear",
            "addmv", "addbmm"}

@dataclass
class CostResult:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0          # payload (result) bytes
    collective_wire_bytes: float = 0.0     # ring-model wire bytes
    per_collective: Dict[str, float] = field(default_factory=dict)

    def scaled(self, k: float) -> "CostResult":
        return CostResult(
            self.flops * k, self.bytes * k, self.collective_bytes * k,
            self.collective_wire_bytes * k,
            {kk: v * k for kk, v in self.per_collective.items()})

    def add(self, other: "CostResult") -> None:
        self.flops += other.flops
        self.bytes += other.bytes
        self.collective_bytes += other.collective_bytes
        self.collective_wire_bytes += other.collective_wire_bytes
        for k, v in other.per_collective.items():
            self.per_collective[k] = self.per_collective.get(k, 0.0) + v


def tensors(tree) -> List[torch.Tensor]:
    """Every tensor in a nest of lists, tuples and dicts."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in tensors(x)]
    return []


def stored_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` reads: a broadcast (stride 0) dim
    counts once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n


def collective_kind(name: str):
    """'all-gather' etc. for a collective op's name, else None."""
    for key, kind in (("all_gather", "all-gather"),
                      ("reduce_scatter", "reduce-scatter"),
                      ("all_reduce", "all-reduce"),
                      ("all_to_all", "all-to-all"),
                      ("alltoall", "all-to-all")):
        if key in name:
            return kind
    return None


def matmul_flops(name: str, args, out) -> float:
    """2 * |result| * |contracted| of a matmul-family op."""
    res = out.numel()
    if name in ("addmm", "baddbmm", "addmv", "addbmm"):
        a = args[1]
    else:
        a = args[0]
    return 2.0 * res * a.shape[-1]


def _in_shape_propagation(args) -> bool:
    """DTensor infers output shapes by running the op on fake tensors,
    and derives the sharding of an op it has no rule for by running the
    op's decomposition on meta tensors of the global shape that carry
    a ``_spec`` (the first time a process meets the op: the result is
    cached); those runs are not the card's work."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return (any(isinstance(m, FakeTensorMode)
                for m in _get_current_dispatch_mode_stack())
            or any(hasattr(t, "_spec") for t in tensors(args)))


def _where() -> str:
    """'fwd', or the autograd node whose backward dispatched the op."""
    node = getattr(torch._C, "_current_autograd_node", lambda: None)()
    return "fwd" if node is None else node.name()


class OpCounter(TorchDispatchMode):
    """Counts FLOPs, bytes, collectives and live memory of the ops run
    inside ``with OpCounter() as c:``; read ``c.cost``, ``c.temp_bytes``
    and ``c.breakdown()`` afterwards."""

    def __init__(self):
        super().__init__()
        self.cost = CostResult()
        self.rows: Dict[tuple, Dict[str, float]] = {}
        self.live_bytes = 0
        self.temp_bytes = 0
        self._storages: Dict[int, int] = {}
        self.last_op = None            # the op entered last (error records)

    # ------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.last_op = str(func)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _in_shape_propagation((args, kwargs)):
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func.__name__.split(".")[0]
        outs = tensors(out)
        kind = collective_kind(name)
        if name in _FREE or (getattr(func, "is_view", False) and kind is None):
            return
        ins = tensors(args) + [t for k, v in kwargs.items() if k != "out"
                                for t in tensors(v)]
        c = CostResult()
        if kind is not None:
            payload = float(sum(t.nbytes for t in outs))
            c.collective_bytes = payload
            c.collective_wire_bytes = _WIRE_FACTOR.get(kind, 1.0) * payload
            c.per_collective[kind] = payload
            c.bytes = float(sum(stored_bytes(t) for t in ins) + payload)
        else:
            if name in _MATMULS:
                c.flops = matmul_flops(name, args, outs[0])
            c.bytes = float(self._io_bytes(name, ins, outs))
        self._track(ins, outs)
        trips = _trips()
        c = c.scaled(trips)
        self.cost.add(c)
        label = (_where(), self._label(func, outs))
        row = self.rows.setdefault(label, {"flops": 0.0, "bytes": 0.0,
                                           "collective_bytes": 0.0,
                                           "count": 0.0})
        row["flops"] += c.flops
        row["bytes"] += c.bytes
        row["collective_bytes"] += c.collective_bytes
        row["count"] += trips

    @staticmethod
    def _io_bytes(name: str, ins, outs) -> int:
        if name in _INDEXED_WRITES:
            # (self, dim/indices..., update): read the update and the
            # indices, write the update's bytes into self
            upd = max((stored_bytes(t) for t in ins[1:]), default=0)
            return 2 * upd + sum(stored_bytes(t) for t in ins[1:]) - upd
        if name == "copy_":
            return stored_bytes(ins[1]) + ins[0].nbytes
        if name in ("fill_", "zero_"):
            return ins[0].nbytes
        return (sum(stored_bytes(t) for t in ins)
                + sum(t.nbytes for t in outs))

    @staticmethod
    def _label(func, outs) -> str:
        if not outs:
            return str(func)
        t = outs[0]
        dt = str(t.dtype).replace("torch.", "")
        return f"{func} {dt}[{','.join(str(d) for d in t.shape)}]"

    # --------------------------------------------------------- memory
    def _track(self, ins, outs) -> None:
        seen = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in seen or key in self._storages:
                continue
            nbytes = st.nbytes()
            self._storages[key] = nbytes
            self.live_bytes += nbytes
            self.temp_bytes = max(self.temp_bytes, self.live_bytes)
            weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live_bytes -= self._storages.pop(key, 0)

    # ------------------------------------------------------ breakdown
    def breakdown(self, top: int = 25) -> List[dict]:
        """The ``top`` cost centres, by bytes plus collective bytes:
        one row per (where, op and result shape), ``where`` being "fwd"
        or the autograd node of the backward that ran it."""
        out = [{"where": w, "op": op, **v} for (w, op), v in self.rows.items()]
        out.sort(key=lambda r: -(r["bytes"] + r["collective_bytes"]))
        return out[:top]


def as_dict(counter: OpCounter) -> dict:
    c = counter.cost
    return {"flops": c.flops, "bytes": c.bytes,
            "collective_bytes": c.collective_bytes,
            "collective_wire_bytes": c.collective_wire_bytes,
            "per_collective": dict(c.per_collective),
            "temp_bytes": counter.temp_bytes}


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under an ``OpCounter`` and
    return its per-card flops, bytes, collective bytes (payload, wire,
    per kind) and temp bytes."""
    with OpCounter() as counter:
        fn(*args, **kwargs)
    return as_dict(counter)


def profile(counter: OpCounter, top: int = 25) -> str:
    """The top cost centres of a finished ``OpCounter``, as text."""
    lines = [f"=== top {top} cost centers (per card) ===",
             f"{'bytes':>12s} {'coll_B':>12s} {'GFLOPs':>10s} "
             f"{'count':>8s}  where"]
    for r in counter.breakdown(top):
        lines.append(
            f"{r['bytes']:12.3e} {r['collective_bytes']:12.3e} "
            f"{r['flops'] / 1e9:10.1f} {r['count']:8.0f}  "
            f"{r['where'][:28]}::{r['op']}")
    return "\n".join(lines)
