"""Host-RAM spill: the partitioned fallback for aggregation and join
state past the memory pool.

Counterpart of ``presto_tpu/exec/spill.py`` (the partitioning
spiller's role): a page's rows split by key into K buckets held in
host memory, and each bucket later finishes on the device on its own,
so the device state is bounded by a bucket instead of the whole key
space.  The split is K11 (``kernels/spill_partition.py``): the bucket
of each row and a permutation that groups the live rows by bucket,
then one gather of every column into a contiguous device buffer and
one copy of it into pinned host memory, cut into buckets on the host.
A bucket's columns are views of that pinned buffer, so the copy back
to the card (:meth:`HostPage.rehydrate`) is asynchronous.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.expr.ir import Expr
from presto_tpu_torch.kernels import spill_partition as k11
from presto_tpu_torch.page import Block, Page


@dataclasses.dataclass
class SpillCounter:
    """Bytes written to host buckets (data and validity, as the
    reference's ``spill.bytes``) and the non-empty buckets written."""

    bytes: int = 0
    buckets: int = 0


@dataclasses.dataclass
class HostPage:
    """A page's rows offloaded to host memory (pinned when they came
    from a card): ``(data, valid, type, dictionary)`` per column and a
    row mask, all host tensors."""

    columns: List[Tuple[torch.Tensor, torch.Tensor, object, object]]
    mask: torch.Tensor

    @property
    def num_rows(self) -> int:
        return int(self.mask.sum())

    def nbytes(self) -> int:
        return sum(d.numel() * d.element_size() + v.numel() * v.element_size()
                   for d, v, _, _ in self.columns)

    def rehydrate(self, device) -> Page:
        """The rows as a device page, padded with dead rows to a power of
        two of at least 1024 (as the reference pads them); the copies are
        asynchronous from pinned memory."""
        n = self.mask.shape[0]
        cap = max(1024, 1 << max(0, n - 1).bit_length())
        nb = torch.device(device).type == "cuda"

        def up(a):
            out = torch.zeros((cap,) + tuple(a.shape[1:]), dtype=a.dtype, device=device)
            out[:n].copy_(a, non_blocking=nb)
            return out

        blocks = tuple(Block(up(d), up(v), t, dic) for d, v, t, dic in self.columns)
        return Page(blocks, up(self.mask))


def make_bucket_fn(key_exprs: Sequence[Expr], key_domains, num_buckets: int):
    """page -> ``(bucket ids, perm, counts)`` of K11: the bucket of each
    row by the hash (or exact pack) of its key, and the live rows
    grouped by bucket."""
    from presto_tpu_torch.ops.join import key_columns

    exprs = list(key_exprs)

    def partition(page: Page):
        keys = key_columns(page, exprs, key_domains) if exprs else []
        return k11.spill_partition(keys, page.row_mask, num_buckets)

    return partition


def partition_to_host(page: Page, parts, num_buckets: int,
                      counter: Optional[SpillCounter] = None) -> List[Optional[HostPage]]:
    """Split one page into per-bucket host pages (the spill write) from
    its K11 partition ``parts``; None for an empty bucket."""
    _, perm, counts = parts
    counts_h = counts.cpu().tolist()  # sizes the copy: the one wait before it
    total = int(sum(counts_h))
    if total == 0:
        return [None] * num_buckets
    cols = [(b.data, b.valid) for b in page.blocks]
    buf = k11.gather_columns(cols, perm, total)
    if buf.is_cuda:
        host = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(buf, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    else:
        host = buf
    offs, _ = k11.layout(cols, total)
    views = []
    for b, (d_off, v_off) in zip(page.blocks, offs):
        shape = (total,) + tuple(b.data.shape[1:])
        nd = total * b.data.element_size() * (b.data.shape[1] if b.data.dim() == 2 else 1)
        views.append((host[d_off:d_off + nd].view(b.data.dtype).reshape(shape),
                      host[v_off:v_off + total].view(torch.bool)))
    out: List[Optional[HostPage]] = []
    start = 0
    spilled = 0
    for c in counts_h:
        if c == 0:
            out.append(None)
            continue
        hp = HostPage([(d[start:start + c], v[start:start + c], b.type, b.dictionary)
                       for (d, v), b in zip(views, page.blocks)],
                      torch.ones(c, dtype=torch.bool))
        spilled += hp.nbytes()
        out.append(hp)
        start += c
    if counter is not None:
        counter.bytes += spilled
        counter.buckets += sum(1 for hp in out if hp is not None)
    return out
