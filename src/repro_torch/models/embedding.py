"""Embedding tables of the recsys family (port of
``repro.models.embedding``): the fused-table layout and its lookups at
world size 1.

* ``embedding_bag_xla`` — the reference's XLA formulation of the embedding
  bag (gather, mask, sum in the table's dtype); it has no caller there
  either.  The hand-written kernel is ``repro_torch.kernels.embedding_bag``.
* ``TableLayout`` — fields of ``replicate_threshold`` ids or more share one
  fused "sharded" table, the smaller ones one "replicated" table, each
  field at a fixed row offset; the sharded table's rows are padded to a
  multiple of ``n_shards``.  The port runs on one card and keeps that
  padding as the row granularity, so its row ids equal the reference's.
* ``sharded_lookup`` with ``mesh=None`` — the reference's single-device
  path: per-field ids become fused-table row ids and are gathered, as
  the reference's ``jnp.take`` gathers them.  The gather keeps
  ``jnp.take``'s answers for ids the models never produce: a negative row
  id wraps (−1 is the last row), and one outside [−V, V) gives a NaN row.
  It is not the bag kernel, which treats a negative id as padding.

The sharded all-to-all lookup (a non-``None`` mesh,
``_bucketed_exchange_lookup``) is not ported yet: it raises
``NotImplementedError`` (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

REPLICATE_THRESHOLD = 8192      # tables smaller than this are replicated
_MESH = ("the sharded all-to-all embedding lookup is not ported yet "
         "(ROADMAP Queue 1 item 9); pass mesh=None")


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
    bucket_slack: float = 2.0              # read by the sharded lookup only

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


def _bucketed_exchange_lookup(*args, **kwargs):
    """The all-to-all exchange of the sharded lookup (reference
    ``embedding.py:126``): not ported."""
    raise NotImplementedError(_MESH)


def sharded_lookup(layout: TableLayout, tables: Dict[str, torch.Tensor],
                   indices: torch.Tensor, mesh=None, *,
                   fields: Sequence[int] | None = None) -> torch.Tensor:
    """(B, F) per-field ids → (B, F, D) embeddings (reference
    ``embedding.py:158`` with ``mesh=None``): replicated and sharded
    fields gathered from their fused tables at their absolute offsets.
    ``fields`` names the layout fields of the index columns (default: all,
    in order).  A mesh raises ``NotImplementedError``."""
    if mesh is not None:
        raise NotImplementedError(_MESH)
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
        if pos:
            ids = layout.global_ids(indices[:, pos],
                                    [all_fields[i] for i in pos])
            groups.append((pos, _take(tables[name], ids)))
    if len(groups) == 1:                 # one table: already in order
        return groups[0][1]
    out = torch.empty((b, f, layout.embed_dim),
                      dtype=tables["sharded"].dtype, device=indices.device)
    for pos, vals in groups:
        out[:, pos] = vals
    return out
