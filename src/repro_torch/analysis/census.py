"""The op census: what an eager PyTorch call did, op by op, read from the
ATen ops it dispatched. The port's twin of the JAX package's
`repro/analysis/hlo.py`, which reads the same numbers out of XLA's
optimised HLO text.

    with Census() as c:
        fn(*args)            # meta tensors: shapes, no memory, no device
    c.flops(), c.bytes(), c.peak_bytes, collective_bytes(c)

`Census` is a `TorchDispatchMode`. For each ATen op it records (`Op`)
the op's name, its input and output shapes and dtypes, its product FLOPs
(`torch.utils.flop_counter`'s formulas, the ops `FlopCounterMode` counts,
decomposed where it decomposes them, so the two agree to the FLOP), its
bytes and the mesh coordinate it ran for (`context.data_shard`: the data
coordinate's model rank 0; None outside a mesh step's coordinate).

Bytes are XLA's "bytes accessed": each input read (its memory span, so an
expanded input counts its storage once) plus each output written. Views
(``view``, ``_unsafe_view``, ``expand``, ``t``, ``transpose``,
``permute``, ``slice``, ``select``, ``as_strided``, ``alias`` and every
op whose schema returns an alias) move nothing in eager mode and count
zero, as do bare allocations (``empty``). An in-place op writes its
destination: ``copy_``, ``fill_``, ``zero_`` and ``index_put_`` do not
read it first, and ``index_put_`` writes its values' bytes, not the
whole destination.

`peak_bytes` follows the storages the call creates: each new output
storage is added when an op makes it and taken off when it is freed
(`weakref.finalize` on the storage), the largest sum is the peak. It is
the port's stand-in for ``memory_analysis().temp_size_in_bytes``; the
tensors that exist before the call (arguments) are not in it.

What stands for which function of `hlo.py`:

  * `collective_bytes` / `total_collective_bytes` — the bytes a coordinate
    reads from blocks another coordinate owns (`ShardedTensor` reads: the
    ZeRO-3 gathers, a decode step's cache rows), `moe_shardmap`'s combine
    over "model" and the mesh loss's sums, logged by
    `repro_torch.distributed.sharding` (a forced mesh repeats one device,
    so no device copy shows them);
  * `op_census` — counts by ATen name (products ``mm`` / ``bmm`` /
    ``addmm`` / ``baddbmm``, ``cat``, ``copy_``, ``sort``, ``scatter``,
    ``gather``, ``index``) in place of HLO opcodes;
  * `bytes_with_trailing_dims` — output bytes of ops whose output ends in
    (d1, d2): the (S, S) scores;
  * `bytes_with_chunk_pair` — output bytes carrying two SSD chunk axes
    among their last three;
  * `bytes_of_layout_ops` — output bytes of pure copies and conversions
    (``_to_copy``, ``clone``, ``copy_``: the dtype casts, ``contiguous``'s
    copies and the gathers' block assembly).

What it cannot give: fusion (every eager op reads and writes device
memory, where XLA fuses elementwise chains, so the bytes are an upper
bound on what a fused program moves), elementwise FLOPs (XLA's count has
them; FLOPs here are products only), and how GSPMD would split a dense
product over "model" (the port computes it whole on the data
coordinate's device).
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import context, sharding

ALL = object()  # the coordinate filter that keeps every record

#: ops that move nothing whose schema does not say so (a view, or a bare
#: allocation); every op whose schema returns an alias moves nothing too
_FREE = frozenset({"_unsafe_view", "empty", "empty_like", "empty_strided",
                   "new_empty", "new_empty_strided"})
#: in-place ops that overwrite their destination without reading it
_OVERWRITE = frozenset({"copy_", "fill_", "zero_", "index_put_",
                        "_index_put_impl_"})
#: what `op_census` counts by default
CENSUS_OPS = ("mm", "bmm", "addmm", "baddbmm", "cat", "copy_", "sort",
              "scatter", "gather", "index")
#: pure copies and conversions (`bytes_of_layout_ops`)
LAYOUT_OPS = ("_to_copy", "clone", "copy_")

#: queries the flop counter leaves alone (no op runs)
_QUERIES = {getattr(torch.ops.aten, n).default for n in (
    "sym_is_contiguous", "is_contiguous", "is_strides_like_format",
    "is_non_overlapping_and_dense", "size", "sym_size", "stride",
    "sym_stride", "storage_offset", "sym_storage_offset", "numel",
    "sym_numel", "dim") if hasattr(torch.ops.aten, n)} | {
    torch.ops.aten.is_contiguous.memory_format, torch.ops.prim.layout.default}


class Op(NamedTuple):
    name: str  # the ATen op without its overload: "mm", "copy_"
    in_shapes: tuple
    in_dtypes: tuple
    out_shapes: tuple
    out_dtypes: tuple
    flops: int
    bytes: int  # read plus written
    written: int  # written to the outputs
    coord: tuple | None  # the data coordinate it ran for


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _span(t: torch.Tensor) -> int:
    """Bytes a read of ``t`` touches: its memory span, at most its
    elements (an expanded tensor's storage counts once)."""
    if t.numel() == 0:
        return 0
    span = 1 + sum((n - 1) * abs(s) for n, s in zip(t.shape, t.stride()))
    return min(t.numel(), span) * t.element_size()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _coordinate():
    shard = context.data_shard()
    return None if shard is None else tuple(shard.ranks[0])


class _Recorder(TorchDispatchMode):
    def __init__(self, census: "Census"):
        super().__init__()
        self.census = census

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return NotImplemented
        packet = func._overloadpacket
        # as FlopCounterMode does: an op (an overload, so any op: the
        # formulas are keyed by packet) may decompose first
        if func not in flop_registry and \
                func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        self.census._record(func, packet, args, kwargs, out)
        return out


class Census:
    """Record every ATen op run inside ``with Census() as c:`` (see the
    module's docstring); also the transfers between mesh coordinates
    (`sharding.recording_collectives`)."""

    def __init__(self):
        self.ops: list[Op] = []
        self.collectives: list[tuple] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}
        self._mode = _Recorder(self)
        self._coll = None

    def __enter__(self) -> "Census":
        self._coll = sharding.recording_collectives(self.collectives)
        self._coll.__enter__()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self._mode.__exit__(*exc)
        finally:
            self._coll.__exit__(None, None, None)
        return False

    # -- recording --
    def _record(self, func, packet, args, kwargs, out) -> None:
        name = packet.__name__
        schema = func._schema
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        aliased = any(r.alias_info is not None for r in schema.returns)
        written = {id(a) for a, arg in zip(args, schema.arguments)
                   if arg.alias_info is not None and arg.alias_info.is_write}
        if name in _FREE or (aliased and not written):
            nbytes = writes = 0  # a view, an alias or an allocation
        else:
            reads = sum(_span(t) for t in ins
                        if not (id(t) in written and name in _OVERWRITE))
            if name in ("index_put_", "_index_put_impl_"):
                writes = _nbytes(args[2])
            else:
                writes = sum(_nbytes(t) for t in outs)
            nbytes = reads + writes
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        self.ops.append(Op(
            name, tuple(tuple(t.shape) for t in ins),
            tuple(str(t.dtype) for t in ins),
            tuple(tuple(t.shape) for t in outs),
            tuple(str(t.dtype) for t in outs), flops, nbytes, writes,
            _coordinate()))
        if not aliased:
            held = {t.untyped_storage()._cdata for t in ins}
            for t in outs:
                self._track(t, held)

    def _track(self, t: torch.Tensor, held: set) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in held or key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # -- totals --
    def select(self, coord=ALL) -> list[Op]:
        """The records of ``coord`` (a grid coordinate, None for work
        outside any coordinate, `ALL` for every record)."""
        if coord is ALL:
            return list(self.ops)
        coord = None if coord is None else tuple(coord)
        return [op for op in self.ops if op.coord == coord]

    def flops(self, coord=ALL) -> int:
        """Product FLOPs."""
        return sum(op.flops for op in self.select(coord))

    def bytes(self, coord=ALL) -> int:
        """Bytes read plus bytes written."""
        return sum(op.bytes for op in self.select(coord))

    def text(self, coord=ALL) -> str:
        """One line an op, as a trace to read."""
        return "\n".join(
            f"{op.coord} {op.name} {list(op.in_shapes)} {list(op.in_dtypes)}"
            f" -> {list(op.out_shapes)} {list(op.out_dtypes)} flops "
            f"{op.flops} bytes {op.bytes}" for op in self.select(coord))


def collective_bytes(census: Census, coord=ALL) -> dict[str, int]:
    """Bytes a coordinate received from others, by kind ("all-gather",
    "all-reduce")."""
    out: dict[str, int] = defaultdict(int)
    want = coord if coord is ALL or coord is None else tuple(coord)
    for c, kind, n in census.collectives:
        if want is ALL or (None if c is None else tuple(c)) == want:
            out[kind] += n
    return dict(out)


def total_collective_bytes(census: Census, coord=ALL) -> int:
    return sum(collective_bytes(census, coord).values())


def op_census(census: Census, ops=CENSUS_OPS, coord=ALL) -> dict[str, int]:
    """How many times each ATen op of ``ops`` ran."""
    counts = {op: 0 for op in ops}
    for rec in census.select(coord):
        if rec.name in counts:
            counts[rec.name] += 1
    return counts


def bytes_with_trailing_dims(census: Census, d1: int, d2: int,
                             coord=ALL) -> int:
    """Output bytes of the ops whose output ends with (.., d1, d2): the
    materialised (S, S) attention scores in a probe."""
    total = 0
    for rec in census.select(coord):
        if any(len(s) >= 2 and s[-2] == d1 and s[-1] == d2
               for s in rec.out_shapes):
            total += rec.written
    return total


def bytes_with_chunk_pair(census: Census, chunk: int, coord=ALL) -> int:
    """Output bytes of the ops carrying an SSD (chunk x chunk) decay or
    score matrix: at least two of the output's last three axes are
    ``chunk``."""
    total = 0
    for rec in census.select(coord):
        if any(len(s) >= 2 and sum(d == chunk for d in s[-3:]) >= 2
               for s in rec.out_shapes):
            total += rec.written
    return total


def bytes_of_layout_ops(census: Census, coord=ALL) -> int:
    """Output bytes of pure copies and conversions (`LAYOUT_OPS`)."""
    return sum(rec.written for rec in census.select(coord)
               if rec.name in LAYOUT_OPS)
