"""Hash aggregate exec: the torch counterpart of
``spark_rapids_tpu/sql/physical/aggregate.py`` (complete, partial and final
modes).

Algorithm, as in the JAX package's device branch:
1. group keys -> exact dense ids in first-occurrence order (ops/hash_group);
2. the two-phase sizing: the observed group count is read on the host once
   per batch (one device->host read), and every output table has exactly
   that many rows;
3. every aggregate buffer slot reduces by group id; into a host-sized
   table of at most 256 groups, the exact 0/1 COUNT and any-valid flag sums
   go through the hand-written segmented-sum kernel (ops/kernels.py) and
   double sums through its float64 build; integer sums, MIN and MAX, and
   larger tables take a segmented scatter;
4. group key values are gathered from each group's first row.

Over several partitions the planner splits an aggregate into a partial one
per map partition, a hash exchange by the group keys, and a final one per
reduce partition.  The final one concatenates its partition's partial rows,
merges them with each buffer slot's ``merge_op`` (``_merge_compute``) and
evaluates the results.  The merge has no host-sized table, so it takes the
scatter path, not the segmented-sum kernel, as the JAX package's device
branch does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ... import types as T
from ...columnar.batch import ColumnarBatch
from ...columnar.column import DeviceColumn, null_column
from ...ops import kernels as K
from ...ops.hash_group import group_ids
from ...ops.segmented import seg_max2, seg_min, seg_min2, seg_sum2
from ..expressions.aggregates import (COUNT, MAX, MIN, SUM,
                                      AggregateExpression, AggregateFunction)
from ..expressions.core import (Alias, AttributeReference, EvalContext,
                                Expression, bind_references)
from .base import PhysicalPlan, empty_batch_for

#: flag sums are exact in float32 only below 2^24 rows
_F32_EXACT_ROWS = 1 << 24


def _min_sentinel(dtype: T.DataType):
    if T.is_floating(dtype):
        return float("inf")
    if isinstance(dtype, T.BooleanType):
        return True
    return torch.iinfo(dtype.torch_dtype).max


def _max_sentinel(dtype: T.DataType):
    if T.is_floating(dtype):
        return float("-inf")
    if isinstance(dtype, T.BooleanType):
        return False
    return torch.iinfo(dtype.torch_dtype).min


def group_phase(key_cols: Sequence[DeviceColumn], row_mask: torch.Tensor):
    """Phase A of the two-phase aggregate: (int64 group ids, 0-d int32 group
    count) on the device.  Without keys every live row is group 0 and there
    is always one output row (SQL: an aggregate over zero rows gives one
    row)."""
    if key_cols:
        rank64 = group_ids(key_cols, row_mask)
    else:
        rank64 = torch.where(row_mask, 0, 1).to(torch.int64)
    live_rank = torch.where(row_mask, rank64, -1)
    n_groups = (live_rank.max() + 1).to(torch.int32) if row_mask.numel() \
        else torch.zeros((), dtype=torch.int32, device=row_mask.device)
    if not key_cols:
        n_groups = torch.clamp(n_groups, min=1)
    return rank64, n_groups


def groupby_reduce(key_cols: Sequence[DeviceColumn],
                   slot_cols: Sequence[Tuple[DeviceColumn, torch.Tensor]],
                   ops: Sequence[str], row_mask: torch.Tensor, rank64=None,
                   n_groups=None, out_size: Optional[int] = None):
    """Core groupby: returns (grouped key columns, reduced slot columns,
    n_groups).  Output columns have ``out_size`` rows (default: the input
    capacity); group g lives at index g.  Ids at or past ``out_size`` (dead
    rows) are dropped."""
    cap = row_mask.shape[0]
    dev = row_mask.device
    row_idx = torch.arange(cap, dtype=torch.int32, device=dev)
    if rank64 is None:
        rank64, n_groups = group_phase(key_cols, row_mask)
    rank = rank64.to(torch.int32)
    OUT = out_size or cap

    first_idx = seg_min(torch.where(row_mask, row_idx, cap), rank, OUT, cap)
    first_idx = first_idx.clamp(0, cap - 1)
    group_ok = torch.arange(OUT, dtype=torch.int32, device=dev) < n_groups
    out_keys = [k.gather(first_idx, group_ok) for k in key_cols]

    simple = []  # (slot index, op, col, contrib)
    for i, ((col, contrib), op) in enumerate(zip(slot_cols, ops)):
        if op not in (SUM, COUNT, MIN, MAX):
            raise NotImplementedError(f"aggregate slot op {op}")
        simple.append((i, op, col, contrib & row_mask))
    out_slots: List = [None] * len(slot_cols)
    if not simple:
        return out_keys, out_slots, n_groups

    # small host-sized group table: float32 sums and exact 0/1 flag sums go
    # through the segmented-sum kernel (the JAX package's MXU path), double
    # sums through its float64 build; integer sums stay exact on seg_sum2
    use_kernel = out_size is not None and OUT <= K.SEG_SUM_MAX_GROUPS

    def _additive(cols2, dt, flags=False):
        if use_kernel and dt == torch.float64:
            return K.seg_sum_f64(torch.stack(cols2), rank, OUT).T
        if use_kernel and (dt == torch.float32
                           or (flags and cap < _F32_EXACT_ROWS)):
            stacked = torch.stack([c.to(torch.float32) for c in cols2])
            return K.seg_sum_f32(stacked, rank, OUT).T.to(dt)
        return seg_sum2(torch.stack(cols2, dim=1), rank, OUT)

    contrib_mat = [c.to(torch.int32) for (_, _, _, c) in simple]
    any_mat = _additive(contrib_mat, torch.int32, flags=True) > 0
    by_kind: dict = {}
    for j, (i, op, col, contrib) in enumerate(simple):
        if op == COUNT:
            kind = ("count", torch.int64)
        elif op == SUM:
            kind = ("add", col.data.dtype)
        else:
            kind = ("min" if op == MIN else "max", col.data.dtype)
        by_kind.setdefault(kind, []).append((j, i, op, col, contrib))
    for (kind, dt), items in by_kind.items():
        if kind == "count":
            # 0/1 flag sums: bounded by cap, exact on the kernel path
            red = _additive([contrib.to(dt) for (_, _, _, _, contrib)
                             in items], dt, flags=True)
        elif kind == "add":
            zero = torch.zeros((), dtype=dt, device=dev)
            red = _additive([torch.where(contrib, col.data, zero)
                             for (_, _, _, col, contrib) in items], dt)
        else:
            is_min = kind == "min"
            sent = (_min_sentinel if is_min else _max_sentinel)(
                items[0][3].dtype)
            fill = torch.full((), sent, dtype=dt, device=dev)
            stacked = torch.stack([torch.where(contrib, col.data, fill)
                                   for (_, _, _, col, contrib) in items],
                                  dim=1)
            red = (seg_min2 if is_min else seg_max2)(stacked, rank, OUT,
                                                     sent)
        for out_col, (j, i, op, col, contrib) in enumerate(items):
            if op == COUNT:
                out_slots[i] = DeviceColumn(
                    T.LONG, red[:, out_col].contiguous(), group_ok.clone())
            else:
                out_slots[i] = DeviceColumn(
                    col.dtype, red[:, out_col].contiguous(),
                    any_mat[:, j] & group_ok)
    return out_keys, out_slots, n_groups


class HashAggregateExec(PhysicalPlan):
    """mode: complete | partial | final.

    Partial mode outputs [key cols...] + [slot cols...] under generated
    names (``_g<i>``, ``_s<i>``); final mode consumes that layout.  Outputs
    of the other modes are grouping keys and plain aggregates; an expression
    around an aggregate (``sum(a) * 2``) is not carried yet."""

    MODES = ("complete", "partial", "final")

    def __init__(self, grouping: Sequence[Expression],
                 agg_out: Sequence[Expression], child: PhysicalPlan,
                 mode: str, device: torch.device):
        super().__init__(child)
        if mode not in self.MODES:
            raise NotImplementedError(f"aggregate mode {mode}")
        self.mode = mode
        #: where the output over an empty partition is made
        self.device = torch.device(device)
        self.grouping = list(grouping)
        self.agg_out = list(agg_out)
        self._agg_funcs: List[AggregateFunction] = []
        self._out_spec: List[Tuple[str, int, str]] = []  # (kind, idx, name)
        group_keys = [g.semantic_key() for g in self.grouping]
        seen_funcs: dict = {}

        def register_agg(x) -> int:
            """Slot-source index; semantically equal aggregates share one."""
            func = x
            if isinstance(x, AggregateExpression):
                if x.is_distinct or x.filter is not None:
                    raise NotImplementedError(
                        "DISTINCT and FILTER aggregates")
                func = x.func
            fk = func.semantic_key()
            if fk not in seen_funcs:
                seen_funcs[fk] = len(self._agg_funcs)
                self._agg_funcs.append(func)
            return seen_funcs[fk]

        for e in self.agg_out:
            name = e.name if isinstance(e, (Alias, AttributeReference)) \
                else e.sql()
            inner = e.children[0] if isinstance(e, Alias) else e
            if isinstance(inner, (AggregateExpression, AggregateFunction)):
                self._out_spec.append(("agg", register_agg(inner), name))
            elif inner.semantic_key() in group_keys:
                self._out_spec.append(
                    ("group", group_keys.index(inner.semantic_key()), name))
            else:
                raise NotImplementedError(
                    f"aggregate output {e.sql()}: only grouping keys and "
                    "plain aggregates are carried")

        if mode == "final":
            return  # the child is the partial layout, read by position
        child_attrs = child.output
        self._bound_grouping = [bind_references(g, child_attrs)
                                for g in self.grouping]
        self._bound_inputs = [[bind_references(c, child_attrs)
                               for c in f.children]
                              for f in self._agg_funcs]

    @property
    def output(self):
        if self.mode == "partial":
            out = [AttributeReference(f"_g{i}", g.data_type, True)
                   for i, g in enumerate(self.grouping)]
            slots = [s for f in self._agg_funcs for s in f.slots()]
            return out + [AttributeReference(f"_s{i}", s.dtype, True)
                          for i, s in enumerate(slots)]
        out = []
        for kind, idx, name in self._out_spec:
            if kind == "group":
                g = self.grouping[idx]
                out.append(AttributeReference(name, g.data_type, g.nullable))
            else:
                f = self._agg_funcs[idx]
                out.append(AttributeReference(name, f.data_type, f.nullable))
        return out

    def _eval_slots(self, ctx):
        slot_pairs, ops = [], []
        for f, inputs in zip(self._agg_funcs, self._bound_inputs):
            slot_pairs.extend(f.update_values(ctx,
                                              [e.eval(ctx) for e in inputs]))
            ops.extend(s.op for s in f.slots())
        return slot_pairs, ops

    def _run_partial(self, batch: ColumnarBatch) -> ColumnarBatch:
        """One input batch -> [keys..., slots...] with one row per group.
        Group ids first, then ONE device->host read of the group count, then
        the reductions into a table of exactly that many rows."""
        mask = batch.row_mask()
        ctx = EvalContext(batch)
        keys = [g.eval(ctx) for g in self._bound_grouping]
        rank64, ng = group_phase(keys, mask)
        ng_host = int(ng)
        slot_pairs, ops = self._eval_slots(ctx)
        gk, gs, n = groupby_reduce(keys, slot_pairs, ops, mask, rank64=rank64,
                                   n_groups=ng, out_size=max(ng_host, 1))
        names = tuple(f"_g{i}" for i in range(len(gk))) + \
            tuple(f"_s{i}" for i in range(len(gs)))
        return ColumnarBatch(names, tuple(gk) + tuple(gs), n
                             ).with_known_rows(ng_host)

    def _merge_compute(self, batch: ColumnarBatch) -> ColumnarBatch:
        """Merge the partial layout [keys..., slots...] by its keys into the
        same layout: each slot reduces with its ``merge_op``, and a slot's
        validity says whether it contributes."""
        nk = len(self.grouping)
        keys = list(batch.columns[:nk])
        slots = list(batch.columns[nk:])
        ops = [s.merge_op for f in self._agg_funcs for s in f.slots()]
        pairs = [(c, c.validity) for c in slots]
        gk, gs, n = groupby_reduce(keys, pairs, ops, batch.row_mask())
        return ColumnarBatch(batch.names, tuple(gk) + tuple(gs), n)

    def _empty_output(self) -> ColumnarBatch:
        """The output over no input batch: no row when grouped (or partial);
        one row for a global aggregate, as Spark gives over no rows."""
        if self.grouping or self.mode == "partial":
            return empty_batch_for(self.output, self.device)
        cap, slots = 8, []
        for f in self._agg_funcs:
            for s in f.slots():
                c = null_column(s.dtype, cap, self.device)
                if s.op == COUNT:
                    c = DeviceColumn(
                        T.LONG,
                        torch.zeros(cap, dtype=torch.int64,
                                    device=self.device),
                        torch.ones(cap, dtype=torch.bool, device=self.device))
                slots.append(c)
        names = tuple(f"_s{i}" for i in range(len(slots)))
        return self._finalize(ColumnarBatch.make(names, slots, 1,
                                                 self.device))

    def _finalize(self, batch: ColumnarBatch) -> ColumnarBatch:
        """Evaluate the result expressions over [keys..., slots...]."""
        ctx = EvalContext(batch)
        nk = len(self.grouping)
        keys = list(batch.columns[:nk])
        slots = list(batch.columns[nk:])
        results = []
        si = 0
        for f in self._agg_funcs:
            cnt = len(f.slots())
            results.append(f.evaluate(ctx, slots[si:si + cnt]))
            si += cnt
        cols = [keys[idx] if kind == "group" else results[idx]
                for kind, idx, _ in self._out_spec]
        names = tuple(name for _, _, name in self._out_spec)
        return batch._carry_count(
            ColumnarBatch(names, tuple(cols), batch.num_rows))

    def execute(self, pid):
        child = self.children[0]
        if self.mode == "final":
            partials = list(child.execute(pid))
            if not partials:
                yield self._empty_output()
                return
            merged = partials[0] if len(partials) == 1 \
                else ColumnarBatch.concat(partials)
            # a shuffled partition holds several maps' rows of one key
            yield self._finalize(self._merge_compute(merged))
            return
        partials = [self._run_partial(b) for b in child.execute(pid)]
        if not partials:
            yield self._empty_output()
            return
        # one batch's partial has unique keys by construction, so the
        # cross-batch merge is needed only over several
        out = partials[0] if len(partials) == 1 \
            else self._merge_compute(ColumnarBatch.concat(partials))
        yield out if self.mode == "partial" else self._finalize(out)
