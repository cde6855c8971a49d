"""The exchange of the mesh tier: hash partitioning and its collectives.

Counterpart of ``presto_tpu/parallel/exchange.py`` (the data plane of
Presto's partitioned exchange, ``PartitionedOutputOperator.java:48`` +
``PartitionedOutputBuffer`` + ``ExchangeClient``).  Each shard
bucketizes its rows by target partition and one all-to-all delivers
every bucket.  The target is the reference's: the key packed exactly or
hashed (K1 for key expressions, K1's CANON where a dictionary repeats a
value, K9 or the exact pack kernel), then ``_mix64(key) % n`` in
unsigned 64-bit arithmetic, a dead row sent to n; K21
(``exchange_partition``) computes the target and the whole bucket
layout in one pass: the stable grouping by target, the drop past
``bucket_cap`` and the scatter of every column.  Bucket capacity is
fixed per call; ``fill`` past it means rows were dropped and the caller
retries with a larger bucket, as the reference's waves do.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.expr.ir import Expr
from presto_tpu_torch.kernels import exchange_partition as k21
from presto_tpu_torch.kernels import keys as pk
from presto_tpu_torch.page import Block, Page
from presto_tpu_torch.parallel.mesh import all_gather, all_to_all


def partition_key(page: Page, key_exprs: Sequence[Expr], key_domains=None) -> torch.Tensor:
    """The int64 key the target mixes: ``pack_or_hash_keys`` of the key
    columns (a dead row's key is never read)."""
    from presto_tpu_torch.ops.join import key_columns

    keys = key_columns(page, key_exprs, key_domains)
    if page.row_mask.is_cuda:
        return pk.pack(keys, page.row_mask, False, "partition_targets")
    return pk.masked_plain(keys, page.row_mask, False)[0]


def partition_targets(page: Page, key_exprs: Sequence[Expr], n_parts: int,
                      key_domains=None) -> torch.Tensor:
    """Target partition per row (int32; dead rows -> n_parts)."""
    return k21.exchange_targets(partition_key(page, key_exprs, key_domains), page.row_mask,
                                n_parts)


def _bucketized(page: Page, out) -> Tuple[Page, torch.Tensor]:
    cols, mask, fill = out
    blocks = tuple(Block(d, v, b.type, b.dictionary) for (d, v), b in zip(cols, page.blocks))
    return Page(blocks, mask), fill


def _cols(page: Page):
    return [(b.data, b.valid) for b in page.blocks]


def partition_for_exchange(page: Page, target: torch.Tensor, n_parts: int,
                           bucket_cap: int) -> Tuple[Page, torch.Tensor]:
    """Scatter rows into ``n_parts`` contiguous buckets of ``bucket_cap``
    rows each (bucket p at rows [p*bucket_cap, (p+1)*bucket_cap)), each
    bucket in row order.  Returns (bucketized page, max bucket fill):
    fill > bucket_cap means rows were dropped."""
    return _bucketized(page, k21.exchange_partition(None, page.row_mask, n_parts, bucket_cap,
                                                    _cols(page), targets=target))


def partition_page(page: Page, key_exprs: Sequence[Expr], n_parts: int, bucket_cap: int,
                   key_domains=None) -> Tuple[Page, torch.Tensor]:
    """``partition_for_exchange(page, partition_targets(page, ...))`` in
    one K21 launch sequence from the packed key."""
    key = partition_key(page, key_exprs, key_domains)
    return _bucketized(page, k21.exchange_partition(key, page.row_mask, n_parts, bucket_cap,
                                                    _cols(page)))


def shard_buckets(pages: Sequence[Page], key_exprs: Sequence[Expr], n_parts: int,
                  key_domains=None, bucket_cap: Optional[int] = None,
                  ) -> Tuple[List[Page], List[torch.Tensor], int]:
    """Every shard's page bucketized on its key for the all-to-all:
    ``(pages, fills, bucket_cap)``.  Without a ``bucket_cap`` the
    buckets are sized from the count: K21's first pass on every shard,
    then the largest fill over the shards, read once, is the capacity
    of every shard's scatter, so no row is dropped (the port sizes its
    outputs from a count; the reference's static buckets retry on
    overflow)."""
    layouts = [k21.exchange_layout(partition_key(p, key_exprs, key_domains), p.row_mask, n_parts)
               for p in pages]
    if bucket_cap is None:
        bucket_cap = max(int(torch.stack([lay.fill for lay in layouts]).max()), 1)
    parts = [_bucketized(p, k21.exchange_scatter(lay, p.row_mask, n_parts, bucket_cap, _cols(p)))
             for p, lay in zip(pages, layouts)]
    return [b for b, _ in parts], [f for _, f in parts], bucket_cap


def exchange_page(pages: Sequence[Page]) -> List[Page]:
    """All-to-all the shards' bucketized pages: bucket p of shard s
    arrives at shard p as bucket s."""
    return all_to_all(pages)


def broadcast_gather_page(pages: Sequence[Page]) -> List[Page]:
    """All-gather the shards' pages (the broadcast exchange,
    ``BroadcastOutputBuffer.java``): every shard ends up with every
    row."""
    return all_gather(pages)
