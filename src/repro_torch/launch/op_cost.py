"""Per-device op-cost counter: the counterpart of ``repro/launch/hlo_cost.py``.

The JAX package re-derives a step's FLOPs, HBM bytes and collective bytes
from its partitioned HLO text.  The port has no HLO: its compiled program
is the eager sequence of aten ops each device runs, so this counter reads
those ops.  ``OpCounter`` is a dispatch mode that sees every aten op a
function runs on ``meta`` tensors, the device's work without the work.
It raises on any other tensor that holds data, so it never counts, or
does, real work.  The one exemption is host bookkeeping: host scalars,
empty host tensors and host tensors of integers or booleans (an
optimizer's step counter, checkpoint's marker, DTensor's shard sizes and
offsets), which it runs uncounted, as it does the fake tensors with
which DTensor's sharding propagation works out its results' shapes.  It
is an "infra" mode that gives DTensor ops back to DTensor
(``NotImplemented``), so it sees the *local* ops DTensor runs beneath,
collectives included: the counts are per device, as the JAX analyzer's
are from the partitioned HLO.

* **FLOPs**: ``2 * (result elements) * (contraction size)`` for every
  matmul-class op (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``,
  ``dot``: ``matmul``, ``linear`` and ``einsum`` reach the dispatcher as
  these), and ``2 * (result elements)`` for a convolution, JAX's
  approximation.  Nothing else counts, as in ``_dot_flops``.
* **Bytes**: operand plus result bytes of every op.  An eager op is a
  kernel boundary, as a fusion is for XLA.  The special cases follow
  ``cost_of``: views (``view``, ``expand``, ``t``, ``permute``,
  ``slice``, ``select``, ``detach``, ...) and allocations cost nothing;
  gathers (``index``, ``index_select``, ``gather``, ``embedding``) count
  twice their result, the slice they read; in-place writes of part of a
  tensor (``index_put_``, ``scatter``, ``index_add``) count twice what
  is written (the operands other than the destination), ``copy_`` its
  source and its destination.  A dtype cast (``_to_copy``) counts as any
  other op: the JAX analyzer treats a pure convert as an alias of its
  source (a CPU-backend artifact there, since TPU matmuls take bf16
  natively), but the card runs the cast as a kernel of its own.
* **Score bytes**: f32/bf16 tensors of rank 4 or more that JAX's
  ``_is_score_shape`` rule picks (attention scores, by ``score_dims``,
  the KV lengths) are counted in ``score_bytes``, not ``bytes``: the
  hand-written kernels keep them in shared memory.  ``score_bytes`` is
  JAX's ``vmem_class_bytes`` renamed, the one key that differs; and
  ``bytes_xla_path`` keeps its name for ``bytes + score_bytes``, the
  traffic of the plain path (``impl="torch"``, the counterpart of XLA's).
* **Collectives**: the result bytes of each ``_c10d_functional``
  collective, by kind (JAX's kind names), with a count.  On a ``"cpu"``
  mesh DTensor turns an all-to-all into an all-gather and a chunk (gloo
  has no all-to-all); while a counter is active it is sent to
  ``_dtensor.shard_dim_alltoall`` as on the card, so it is counted as the
  all-to-all the program asks for.
* **Trip counts**: ``cost_hooks.steps(n)`` is the counterpart of
  ``known_trip_count`` (see ``repro_torch/cost_hooks.py``): under a
  counter (``region``) one step counts ``n`` times; regions nest and
  multiply.  The autograd nodes the region makes are tagged, so their
  backward is multiplied alike (``torch.utils.checkpoint`` recomputes a
  function when its last node with saved tensors runs backward, so a
  checkpointed function must not end inside a region, or its
  recomputation is multiplied too).
* **Hand kernels**: a kernel wrapper called on meta tensors launches
  nothing this mode could see; it charges its kernel's work through
  ``cost_hooks.charge`` (``charge``): its operations, and the bytes it
  moves, each input read once and each output written once.  So a step
  with ``attention_impl="cuda"`` is counted as the program the card runs.

``analyze_ops(fn, *args, score_dims=...)`` runs ``fn`` under a counter
and returns ``analyze_hlo``'s keys.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import cost_hooks

# aten op names (overload packets) by how they are counted
_FREE = frozenset({
    "view", "_unsafe_view", "_reshape_alias", "reshape", "expand", "t",
    "transpose", "permute", "squeeze", "unsqueeze", "as_strided", "slice",
    "select", "detach", "alias", "unbind", "split", "split_with_sizes",
    "chunk", "narrow", "diagonal", "unfold", "view_as_real",
    "view_as_complex", "lift_fresh", "empty", "empty_like", "empty_strided",
    "new_empty", "new_empty_strided", "wait_tensor", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
    "_has_compatible_shallow_copy_type", "resolve_conj", "resolve_neg"})
_MATMUL = frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv",
                     "addmv", "dot", "vdot"})
_CONV = frozenset({"convolution", "_convolution"})
_GATHER = frozenset({"index", "index_select", "gather", "embedding",
                     "take", "take_along_dim"})
_PARTIAL_WRITE = frozenset({"index_put", "index_put_", "_index_put_impl_",
                            "scatter", "scatter_", "scatter_add",
                            "scatter_add_", "scatter_reduce",
                            "scatter_reduce_", "index_add", "index_add_",
                            "index_copy", "index_copy_"})
_COLL_KIND = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "permute_tensor": "collective-permute",
}


def _tensors(args, kwargs) -> list:
    """The tensors among ``args`` and ``kwargs``' values, and in the lists
    and tuples among them (aten ops nest no deeper)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _propagating(types) -> bool:
    """Whether a fake-tensor mode is on, or a fake tensor in the op: DTensor
    works out its results' shapes so."""
    from torch._subclasses.fake_tensor import FakeTensor
    return (torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)
            is not None or any(issubclass(t, FakeTensor) for t in types))


def _bookkeeping(t: torch.Tensor) -> bool:
    """A host scalar, an empty host tensor or a host tensor of integers or
    booleans: the index arithmetic, counters and markers around the
    device's work (``torch.utils.checkpoint`` makes an empty one)."""
    return t.device.type == "cpu" and (
        t.dim() == 0 or t.numel() == 0
        or not (t.is_floating_point() or t.is_complex()))


def _refuse_data(func, tensors) -> None:
    for t in tensors:
        if not _bookkeeping(t):
            raise RuntimeError(
                f"OpCounter: {func} got a {tuple(t.shape)} {t.dtype} tensor "
                f"on {t.device}; the counter counts meta tensors only (and "
                "runs host scalars, empty and index tensors uncounted)")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    score_bytes: float = 0.0           # attention-score traffic the hand
                                       # kernels keep in shared memory
    coll_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = field(default_factory=dict)
    coll_count: float = 0.0


class OpCounter(TorchDispatchMode):
    """Counts the aten ops run under it on meta tensors; see the module
    docstring.  ``score_dims``: the KV lengths whose f32/bf16 rank >= 4
    tensors are attention scores."""

    def __init__(self, score_dims: Iterable[int] = ()):
        super().__init__()
        self.cost = Cost()
        self.score_dims = {int(d) for d in score_dims}
        self.mult = 1.0
        self._stack: List[float] = []
        self._alltoall = contextlib.ExitStack()

    @classmethod
    def is_infra_mode(cls) -> bool:
        return True

    # ------------------------------------------------------------ regions
    def _push(self, n: float) -> None:
        self._stack.append(n)
        self.mult *= n

    def _pop(self, n: float) -> None:
        self._stack.remove(n)
        self.mult = 1.0
        for m in self._stack:
            self.mult *= m

    def region(self, n: int):
        if n <= 0:
            return
        self._push(n)
        tagger = _NodeTagger()
        try:
            with tagger:
                yield 0
        finally:
            self._pop(n)
        for node in tagger.nodes:
            node.register_prehook(lambda go, n=n: self._push(n))
            node.register_hook(lambda gi, go, n=n: self._pop(n))

    # ------------------------------------------------------------ entry
    def __enter__(self):
        cost_hooks.enter(self)
        self._alltoall.enter_context(_native_alltoall())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._alltoall.close()
            cost_hooks.leave(self)

    # ------------------------------------------------------------ counting
    def _is_score(self, t: torch.Tensor) -> bool:
        if not self.score_dims or t.dtype not in (torch.float32,
                                                  torch.bfloat16):
            return False
        dims = list(t.shape)
        if len(dims) < 4:
            return False
        smax = max(self.score_dims)
        cand = max(dims[-1], dims[-2])
        if t.dtype == torch.float32:
            return 1024 <= cand <= smax and cand % 1024 == 0
        return dims[-1] in self.score_dims or dims[-2] in self.score_dims

    def _split(self, tensors) -> tuple:
        """(hbm bytes, score bytes) of ``tensors``."""
        hbm = score = 0
        for t in tensors:
            if self._is_score(t):
                score += _nbytes(t)
            else:
                hbm += _nbytes(t)
        return hbm, score

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _propagating(types):
            # DTensor's sharding propagation working out a result's shape
            # under a fake-tensor mode: no device work
            return func(*args, **kwargs)
        if any(t is not torch.Tensor for t in types):
            # a tensor subclass (DTensor, a collective's async result):
            # let it run, and count the plain ops it runs beneath
            return NotImplemented
        ins = _tensors(args, kwargs)
        held = [t for t in ins if t.device.type != "meta"]
        _refuse_data(func, held)
        out = func(*args, **kwargs)
        outs = _tensors((out,), {})
        host = [t for t in outs if t.device.type != "meta"]
        _refuse_data(func, host)
        if host or (held and len(held) == len(ins)):
            # host bookkeeping: an optimizer's step counter, DTensor's
            # shard sizes and offsets
            return out
        self._account(func, args, ins, out)
        return out

    def charge(self, flops: float, nbytes: float) -> None:
        """A hand kernel's work (``cost_hooks.charge``), times the trip
        counts of the regions around it."""
        self.cost.flops += self.mult * flops
        self.cost.bytes += self.mult * nbytes

    def _account(self, func, args, ins, out) -> None:
        name = func._overloadpacket.__name__
        if name in _FREE:
            return
        ns = func.namespace
        m = self.mult
        c = self.cost
        outs = _tensors((out,), {})
        kind = _COLL_KIND.get(name) if ns in ("_c10d_functional", "c10d",
                                               "_dtensor") else None
        if kind is not None:
            rb = sum(_nbytes(o) for o in outs)
            c.coll_bytes += m * rb
            c.coll_count += m
            c.coll_by_kind[kind] = c.coll_by_kind.get(kind, 0.0) + m * rb
        if name in _GATHER:
            rb, rs = self._split(outs)
            c.bytes += m * 2 * rb
            c.score_bytes += m * 2 * rs
            return
        if name in _PARTIAL_WRITE:
            # the operands past the destination: indices and updates
            written = [a for a in ins[1:]]
            wb, ws = self._split(written)
            c.bytes += m * 2 * wb
            c.score_bytes += m * 2 * ws
            return
        if name == "copy_":
            hb, hs = self._split(ins)          # destination and source
            c.bytes += m * hb
            c.score_bytes += m * hs
            return
        if name in _MATMUL:
            k = ins[-2].shape[-1] if name in ("addmm", "baddbmm", "addbmm",
                                               "addmv") else ins[0].shape[-1]
            c.flops += m * 2.0 * sum(o.numel() for o in outs) * k
        elif name in _CONV:
            c.flops += m * 2.0 * sum(o.numel() for o in outs)
        rb, rs = self._split(outs)
        ob, os_ = self._split(ins)
        if rs and not rb:
            # a score-class result: its traffic and its score operands'
            # stay on chip, its other operands are read from memory
            c.score_bytes += m * (rs + os_)
            c.bytes += m * ob
        else:
            c.bytes += m * (rb + ob)
            c.score_bytes += m * (rs + os_)


class _NodeTagger(TorchFunctionMode):
    """Collects the autograd nodes the calls under it make: those of
    their results, and the new node of a tensor written in place."""

    def __init__(self):
        super().__init__()
        self.nodes: list = []
        self._seen: set = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        before = {id(a.grad_fn) for a in _tensors(args, kwargs)
                  if a.grad_fn is not None}
        out = func(*args, **kwargs)
        for t in _tensors((out, *args), kwargs):
            node = t.grad_fn
            if node is not None and id(node) not in before \
                    and id(node) not in self._seen:
                self._seen.add(id(node))
                self.nodes.append(node)
        return out


@contextlib.contextmanager
def _native_alltoall():
    """Send DTensor's all-to-all to ``_dtensor.shard_dim_alltoall`` (whose
    meta function gives its local result) instead of the all-gather and
    chunk it uses on a ``"cpu"`` mesh."""
    from torch.distributed.tensor import placement_types as pt
    inner = getattr(pt, "shard_dim_alltoall", None)
    if inner is None:
        yield
        return
    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            mesh.get_group(mesh_dim).group_name)

    pt.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        pt.shard_dim_alltoall = inner


def analyze_ops(fn: Callable, *args, score_dims=(), **kwargs
                ) -> Dict[str, float]:
    """Run ``fn(*args, **kwargs)`` under an ``OpCounter``; returns the JAX
    ``analyze_hlo``'s keys, ``score_bytes`` for ``vmem_class_bytes``."""
    counter = OpCounter(score_dims=score_dims)
    with counter:
        fn(*args, **kwargs)
    c = counter.cost
    out = {
        "flops": c.flops,
        "bytes": c.bytes,                      # kernelized HBM traffic
        "score_bytes": c.score_bytes,
        "bytes_xla_path": c.bytes + c.score_bytes,
        "collective_bytes": c.coll_bytes,
        "collective_count": c.coll_count,
    }
    for k, v in c.coll_by_kind.items():
        out[f"coll_{k}"] = v
    return out
