"""A mesh of n shards on one torch device.

Counterpart of ``jax.sharding.Mesh`` plus the collectives that
``shard_map`` bodies call in ``presto_tpu/parallel``.  The reference
runs one SPMD program per stage over the mesh's devices; here a shard's
data is one :class:`~presto_tpu_torch.page.Page` of a list of n, an
SPMD body is a function over that list, and a collective in the middle
of a program is an explicit barrier between two phases of it:

- :func:`all_to_all`: bucket p of shard s goes to shard p as bucket s
  (``jax.lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)``), a
  transposing copy of the bucketized pages on the device;
- :func:`all_gather`: every shard receives every shard's rows in shard
  order (``jax.lax.all_gather(axis=0, tiled=True)``), a concat.

Every shard lives on the one device, so the collectives are device
copies, with no NCCL call: NCCL will not put two ranks on one card.  A
mesh over several cards in one process is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from presto_tpu_torch import resolve_device
from presto_tpu_torch.page import Block, Page, concat_pages_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n`` shards on ``device``."""

    n: int
    device: torch.device


def make_mesh(n: Optional[int] = None, device=None, session=None) -> Mesh:
    """A mesh of ``n`` shards on ``device`` (default ``cuda``, which must
    be present; ``device="cpu"`` for the CPU).  ``n`` comes from the
    argument, else from the session's ``hash_partition_count``, else the
    device count (the CUDA cards, or 1 on the CPU)."""
    dev = resolve_device(device)
    if not n and session is not None:
        n = int(session.get("hash_partition_count")) or None
    if not n:
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n < 1:
        raise ValueError(f"make_mesh: {n} shards")
    return Mesh(int(n), dev)


def all_to_all(pages: Sequence[Page]) -> List[Page]:
    """Bucketized pages, one a shard, each of capacity n * bucket_cap:
    bucket p of shard s arrives at shard p as bucket s.  Each
    destination's tensor is one concatenation of its buckets (a single
    copy of the exchanged rows)."""
    n = len(pages)
    cap = pages[0].capacity // n if n else 0
    if any(p.capacity != n * cap for p in pages):
        raise ValueError("all_to_all: every page must hold n buckets of one capacity")

    def gather(xs: Sequence[torch.Tensor], p: int) -> torch.Tensor:
        return torch.cat([x[p * cap:(p + 1) * cap] for x in xs])

    out = []
    for p in range(n):
        blocks = tuple(Block(gather([q.blocks[i].data for q in pages], p),
                             gather([q.blocks[i].valid for q in pages], p), b.type, b.dictionary)
                       for i, b in enumerate(pages[0].blocks))
        out.append(Page(blocks, gather([q.row_mask for q in pages], p)))
    return out


def all_gather(pages: Sequence[Page]) -> List[Page]:
    """Every shard's page, concatenated in shard order, on every shard
    (one tensor shared by all)."""
    whole = concat_pages_device(list(pages))
    return [whole] * len(pages)
