"""Embedding tables of the recsys family (port of
``repro.models.embedding``): the fused-table layout and its lookups.

* ``embedding_bag_xla`` — the reference's XLA formulation of the embedding
  bag (gather, mask, sum in the table's dtype); it has no caller there
  either.  The hand-written kernel is ``repro_torch.kernels.embedding_bag``.
* ``TableLayout`` — fields of ``replicate_threshold`` ids or more share one
  fused "sharded" table, the smaller ones one "replicated" table, each
  field at a fixed row offset; the sharded table's rows are padded to a
  multiple of ``n_shards``, so its row ids equal the reference's.
* ``sharded_lookup`` with ``mesh=None`` — the reference's single-device
  path: per-field ids become fused-table row ids and are gathered, as
  the reference's ``jnp.take`` gathers them.  The gather keeps
  ``jnp.take``'s answers for ids the models never produce: a negative row
  id wraps (−1 is the last row), and one outside [−V, V) gives a NaN row.
  It is not the bag kernel, which treats a negative id as padding.

* ``sharded_lookup`` with a mesh — the DLRM / FBGEMM model-parallel
  lookup, SPMD over every rank of the mesh: each rank holds its
  ``(sharded_rows / P, D)`` block of the sharded table (rank order along
  the flattened mesh) and its batch shard of the ids, routes each
  sharded-field lookup to the rank that owns the row and gets the row
  back (``_bucketed_exchange_lookup``: two ``dist.all_to_all_single``
  calls over a group of every mesh rank, tensors on the mesh's device
  type).  The bucket capacity, ``max(int(l_loc / P · bucket_slack),
  min(l_loc, 64))`` for ``l_loc`` lookups a rank, and the drop rule — a
  lookup past its bucket's capacity returns zeros, never another row —
  are the reference's.  Replicated fields are local gathers.  Ids must
  be rows of the table.  The exchange is differentiable
  (``_ExchangeLookup``): its backward sends each looked-up row's
  gradient back to the owner rank with the reverse all-to-all, which
  sums it into its block in a fixed order; dropped and empty slots add
  nothing.
* ``table_specs`` — the tables' partition specs: the sharded table's rows
  over the batch axes, the replicated table whole.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import P
from repro_torch.models.common import order_slots

REPLICATE_THRESHOLD = 8192      # tables smaller than this are replicated


def _take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)``: rows of ``table`` for ``ids`` of
    any shape, a negative id counted from the end, an id outside [−V, V)
    a NaN row."""
    n = table.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + n, ids)
    outside = (ids < 0) | (ids >= n)
    rows = table[ids.clamp(0, max(n - 1, 0))]
    return rows.masked_fill_(outside[..., None], float("nan"))


def embedding_bag_xla(table: torch.Tensor, indices: torch.Tensor, *,
                      combiner: str = "sum") -> torch.Tensor:
    """(V, D) × (B, L) with -1 padding → (B, D) (reference
    ``embedding.py:43``): the gathered rows masked and summed over L in
    the table's dtype, the mean divided by max(count, 1)."""
    valid = indices >= 0
    rows = _take(table, torch.where(valid, indices, 0))
    rows = rows * valid[..., None].to(table.dtype)
    out = rows.sum(dim=1)
    if combiner == "mean":
        out = out / valid.sum(dim=1, keepdim=True).clamp_min(1).to(out.dtype)
    return out


@dataclasses.dataclass(frozen=True)
class TableLayout:
    """Static layout: which fields live in the sharded vs replicated table
    (reference ``embedding.py:57``; same fields and properties)."""
    field_sizes: Tuple[int, ...]          # vocab per field
    embed_dim: int
    n_shards: int                          # row padding granularity
    replicate_threshold: int = REPLICATE_THRESHOLD
    bucket_slack: float = 2.0              # the sharded lookup's buckets

    @property
    def sharded_fields(self) -> Tuple[int, ...]:
        return tuple(i for i, s in enumerate(self.field_sizes)
                     if s >= self.replicate_threshold)

    @property
    def replicated_fields(self) -> Tuple[int, ...]:
        return tuple(i for i, s in enumerate(self.field_sizes)
                     if s < self.replicate_threshold)

    def _field_offset(self, field: int) -> int:
        """Offset of ``field``'s rows within its (sharded|replicated) table."""
        home = self.sharded_fields if field in self.sharded_fields \
            else self.replicated_fields
        off = 0
        for f in home:
            if f == field:
                return off
            off += self.field_sizes[f]
        raise KeyError(field)

    @property
    def sharded_rows(self) -> int:
        n = sum(self.field_sizes[f] for f in self.sharded_fields)
        rem = n % self.n_shards                  # pad to divide over shards
        return n + (self.n_shards - rem if rem else 0)

    @property
    def replicated_rows(self) -> int:
        return max(sum(self.field_sizes[f] for f in self.replicated_fields),
                   1)

    def global_ids(self, indices: torch.Tensor, fields: Sequence[int]
                   ) -> torch.Tensor:
        """Per-field ids (B, |fields|) → fused-table row ids, in the ids'
        dtype.  Offsets are absolute per field (stable under subset
        lookups)."""
        offs = torch.tensor([self._field_offset(f) for f in fields],
                            dtype=indices.dtype, device=indices.device)
        return indices + offs[None, :]

    def total_params(self) -> int:
        return (self.sharded_rows + self.replicated_rows) * self.embed_dim


def init_tables(layout: TableLayout, generator: torch.Generator,
                scale: float = 0.01, device=None) -> Dict[str, torch.Tensor]:
    """{"sharded": (sharded_rows, D), "replicated": (replicated_rows, D)}
    f32 normals · ``scale`` (reference ``embedding.py:111``), drawn from
    ``generator`` on its device unless ``device`` says otherwise and scaled
    in place, so a table of tens of GB never exists twice.  Same shapes
    and scale as the reference; not its numbers."""
    device = torch.device(device if device is not None
                          else generator.device)
    out = {}
    for name, rows in (("sharded", layout.sharded_rows),
                       ("replicated", layout.replicated_rows)):
        table = torch.randn((rows, layout.embed_dim), generator=generator,
                            device=device, dtype=torch.float32)
        out[name] = table.mul_(scale)
    return out


def table_specs(batch_axes=("pod", "data", "model")):
    """The tables' specs (reference ``embedding.py:122``): the sharded
    table's rows over ``batch_axes``, the replicated table whole."""
    return {"sharded": P(batch_axes, None), "replicated": P(None, None)}


def _row_sum(rows: torch.Tensor, vals: torch.Tensor, n_rows: int
             ) -> torch.Tensor:
    """(n_rows, D) zeros with each ``vals[i]`` added into row
    ``rows[i]`` in a fixed order: ``index_add_`` on the CPU (sequential),
    ``index_put_(accumulate=True)`` on CUDA (its CUDA path sorts the ids
    and sums each row's values in one thread, where ``index_add_`` would
    add in atomic order)."""
    out = vals.new_zeros((n_rows, vals.shape[1]))
    if vals.is_cuda:
        return out.index_put_((rows,), vals, accumulate=True)
    return out.index_add_(0, rows, vals)


def _exchange_slots(owner: torch.Tensor, n_shards: int, capacity: int):
    """Each lookup's (bucket, slot) and whether it fits: the next slot of
    its owner's bucket in lookup order (the reference's one-hot cumsum,
    as ``common.order_slots``); a lookup past ``capacity`` goes to the
    drop row ``n_shards``."""
    pos = order_slots(owner.long())                             # (L,)
    keep = pos < capacity
    slot_o = torch.where(keep, owner.long(), n_shards)
    slot_p = torch.where(keep, pos, 0)
    return slot_o, slot_p, keep


class _ExchangeLookup(torch.autograd.Function):
    """The exchange of :func:`_bucketed_exchange_lookup` with its
    gradient: the (P, C, D) value gradients go back to the owner ranks
    with the reverse all-to-all and are summed into the rows they were
    read from (:func:`_row_sum`).  An empty send slot carries the row id
    −1 (the reference sends 0 and discards what comes back; the values
    are the same): it reads row 0 in the forward and adds nothing in the
    backward, and a dropped lookup's gradient is zeroed, so neither adds
    gradient to row 0 — nor makes row 0 a hot row of the sum."""

    @staticmethod
    def forward(ctx, local_table, owner, local_row, n_shards, capacity,
                group):
        d = local_table.shape[1]
        slot_o, slot_p, keep = _exchange_slots(owner, n_shards, capacity)
        send = torch.full((n_shards + 1, capacity), -1, dtype=torch.int64,
                          device=local_table.device)
        send[slot_o, slot_p] = local_row.long()
        send = send[:n_shards].contiguous()                      # (P, C)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        rows = recv.reshape(-1)
        vals = local_table[rows.clamp(0, local_table.shape[0] - 1)].reshape(
            n_shards, capacity, d)
        back = torch.empty_like(vals)
        dist.all_to_all_single(back, vals, group=group)          # (P, C, D)
        out = back[slot_o.clamp(0, n_shards - 1), slot_p]        # (L, D)
        ctx.save_for_backward(rows, slot_o, slot_p, keep)
        ctx.shape, ctx.group = (n_shards, capacity, d), group
        ctx.n_rows = local_table.shape[0]
        return out.masked_fill(~keep[:, None], 0.0)

    @staticmethod
    def backward(ctx, g):
        rows, slot_o, slot_p, keep = ctx.saved_tensors
        n_shards, capacity, d = ctx.shape
        g = g.masked_fill(~keep[:, None], 0.0)
        gback = g.new_zeros((n_shards + 1, capacity, d))
        gback[slot_o, slot_p] = g                    # kept slots are unique
        gback = gback[:n_shards].contiguous()
        gvals = torch.empty_like(gback)
        dist.all_to_all_single(gvals, gback, group=ctx.group)
        if rows.device.type == "meta":
            # a dry run's: no ids to mask with, so every slot counts as
            # filled (the most the sum can take)
            grad = _row_sum(rows, gvals.reshape(-1, d), ctx.n_rows)
        else:
            filled = rows >= 0
            grad = _row_sum(rows[filled], gvals.reshape(-1, d)[filled],
                            ctx.n_rows)
        return grad, None, None, None, None, None


def _bucketed_exchange_lookup(local_table: torch.Tensor, owner: torch.Tensor,
                              local_row: torch.Tensor, n_shards: int,
                              capacity: int, group) -> torch.Tensor:
    """Route this rank's L lookups to their owner ranks and back
    (reference ``embedding.py:126``).

    ``owner`` / ``local_row``: (L,) owner rank and row within its block.
    Each lookup takes the next slot of its owner's bucket of
    ``capacity``; the (P, C) row ids go out with one all-to-all, every
    owner gathers the rows asked of it, and a second all-to-all brings
    the (P, C, D) values back.  A lookup past its bucket's capacity gets
    zeros.  Returns (L, D), differentiable in ``local_table``."""
    return _ExchangeLookup.apply(local_table, owner, local_row, n_shards,
                                 capacity, group)


def _mesh_group(mesh):
    """The group of every mesh rank: the mesh's own group when it has one
    axis, else the default group, which must hold the mesh's ranks in
    rank order (the order of the table blocks and batch shards)."""
    if mesh.ndim == 1:
        return mesh.get_group(0)
    if mesh.mesh.flatten().tolist() != list(range(dist.get_world_size())):
        raise ValueError("a multi-axis mesh's exchange runs over the "
                         "default group: the mesh must hold every rank, "
                         "in rank order")
    return dist.group.WORLD


def sharded_lookup(layout: TableLayout, tables: Dict[str, torch.Tensor],
                   indices: torch.Tensor, mesh=None, *,
                   fields: Sequence[int] | None = None) -> torch.Tensor:
    """(B, F) per-field ids → (B, F, D) embeddings (reference
    ``embedding.py:158``): replicated and sharded fields gathered from
    their fused tables at their absolute offsets.  ``fields`` names the
    layout fields of the index columns (default: all, in order).

    With ``mesh`` (SPMD, every rank of the mesh calls): ``indices`` is
    this rank's batch shard (the same B on every rank),
    ``tables["sharded"]`` its ``(sharded_rows / P, D)`` block and
    ``tables["replicated"]`` the whole replicated table; the sharded
    fields go through the all-to-all exchange and the result is this
    rank's (B, F, D) shard."""
    all_fields = tuple(fields) if fields is not None \
        else tuple(range(len(layout.field_sizes)))
    b, f = indices.shape
    if f != len(all_fields):
        raise ValueError(f"{f} index columns for {len(all_fields)} fields")
    sharded = set(layout.sharded_fields)
    groups = []
    for name, home in (("replicated", False), ("sharded", True)):
        pos = [i for i, fl in enumerate(all_fields)
               if (fl in sharded) == home]
        if not pos:
            continue
        ids = layout.global_ids(indices[:, pos],
                                [all_fields[i] for i in pos])
        if home and mesh is not None:
            vals = _exchange(layout, tables[name], ids, mesh)
        else:
            vals = _take(tables[name], ids)
        groups.append((pos, vals))
    if len(groups) == 1:                 # one table: already in order
        return groups[0][1]
    out = torch.empty((b, f, layout.embed_dim),
                      dtype=tables["sharded"].dtype, device=indices.device)
    for pos, vals in groups:
        out[:, pos] = vals
    return out


def _exchange(layout: TableLayout, block: torch.Tensor, ids: torch.Tensor,
              mesh) -> torch.Tensor:
    """The sharded fields' (B, Fs) fused-table ids of this rank's batch
    shard → (B, Fs, D) rows through the all-to-all exchange."""
    # a dry run's meta tensors pass on its fake group's mesh
    takes = (mesh.device_type, "meta")
    if ids.device.type not in takes or block.device.type not in takes:
        raise ValueError(f"ids on {ids.device.type} and the table block on "
                         f"{block.device.type}, but the mesh's collectives "
                         f"take {mesh.device_type} tensors")
    group, n = _mesh_group(mesh), mesh.size()
    if layout.sharded_rows % n:
        raise ValueError(f"{layout.sharded_rows} sharded rows do not divide "
                         f"over {n} ranks")
    rows_per_shard = layout.sharded_rows // n
    if block.shape[0] != rows_per_shard:
        raise ValueError(f"each rank passes its ({rows_per_shard}, D) block "
                         f"of the sharded table, got {tuple(block.shape)}")
    l_loc = ids.numel()
    capacity = max(int(l_loc / n * layout.bucket_slack), min(l_loc, 64))
    flat = ids.reshape(-1).long()
    got = _bucketed_exchange_lookup(block, flat // rows_per_shard,
                                    flat % rows_per_shard, n, capacity,
                                    group)
    return got.reshape(ids.shape + (block.shape[1],))
