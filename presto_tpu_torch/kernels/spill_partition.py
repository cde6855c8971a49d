"""K11 ``spill_partition``: a page's rows split into K spill buckets by
their key.

:func:`spill_partition` computes, for one page, what the reference's
``make_bucket_fn`` and ``partition_to_host`` compute together
(``presto_tpu/exec/spill.py``): the bucket of each live row (its key
packed exactly or hashed, as ``pack_or_hash_keys`` does, remixed
``h ^= h >> 33; h *= 0xFF51AFD7ED558CCD; h ^= h >> 33`` and reduced
mod K, all unsigned 64-bit), and the live rows' indices grouped by
bucket, each bucket in page order (the reference's ``np.nonzero``
order), with each bucket's count.  :func:`gather_columns` then copies
the page's columns through that permutation into one contiguous
buffer, which the spill copies to the host in one transfer.  CUDA
tensors launch ``csrc/spill_partition.cu``; CPU tensors run the plain
versions.  Torch has no unsigned 64-bit arithmetic on the CPU, so the
plain version shifts logically as ``keys.py`` does, multiplies in
wrapping int64 (the same bits) and takes the unsigned remainder of a
negative int64 as ``((x & INT64_MAX) % K + 2**63 % K) % K``.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from presto_tpu_torch.kernels import build
from presto_tpu_torch.kernels import keys as pk

MAX_BUCKETS = 256  # csrc/spill_partition.cu K11_MAX_BUCKETS
MAX_COLS = 64  # columns gathered by one launch: csrc/gather.cuh GATHER_MAX_COLS
ALIGN = 16  # byte alignment of each column's segment in a gathered buffer
_REMIX = 0xFF51AFD7ED558CCD - (1 << 64)  # as signed int64

#: K11 launch sequences (one per page partitioned), and the launches of
#: its column gather
launches = 0
gather_launches = 0

Column = Tuple[torch.Tensor, torch.Tensor]


def _check(keys: Sequence[pk.Key], row_mask: torch.Tensor, num_buckets: int) -> int:
    n = row_mask.shape[0]
    if row_mask.dtype != torch.bool or row_mask.dim() != 1 or not 1 <= n < (1 << 31):
        raise ValueError("spill_partition: row_mask must be (n,) bool, 1 <= n < 2^31")
    if not 1 <= num_buckets <= MAX_BUCKETS:
        raise ValueError(f"spill_partition: 1 to {MAX_BUCKETS} buckets, not {num_buckets}")
    if keys:
        pk.check(keys, n, "spill_partition")
    return n


def bucket_ids_plain(keys: Sequence[pk.Key], row_mask: torch.Tensor,
                     num_buckets: int) -> torch.Tensor:
    """int32 bucket of each row, -1 for a dead row; the plain version
    (no keys: every live row in bucket 0)."""
    n = row_mask.shape[0]
    key, _ = pk.pack_plain(keys, n, row_mask.device)  # a NULL key buckets by its code
    h = key ^ pk._srl(key, 33)
    h = h * _REMIX
    h = h ^ pk._srl(h, 33)
    b = ((h & pk.I64_MAX) % num_buckets + (h < 0).to(torch.int64) * ((1 << 63) % num_buckets)) \
        % num_buckets
    return torch.where(row_mask, b, torch.full_like(b, -1)).to(torch.int32)


def spill_partition_plain(keys: Sequence[pk.Key], row_mask: torch.Tensor, num_buckets: int):
    """``(bucket ids, perm, counts)``; the plain version.  ``perm`` has n
    entries: the first ``counts.sum()`` are the live rows by bucket,
    each bucket in row order; the rest are 0."""
    _check(keys, row_mask, num_buckets)
    bids = bucket_ids_plain(keys, row_mask, num_buckets)
    live = torch.nonzero(row_mask).flatten()
    lb = bids[live].to(torch.int64)
    _, order = torch.sort(lb, stable=True)
    perm = torch.zeros(row_mask.shape[0], dtype=torch.int32, device=row_mask.device)
    perm[:live.numel()] = live[order].to(torch.int32)
    counts = torch.bincount(lb, minlength=num_buckets)
    return bids, perm, counts


def spill_partition(keys: Sequence[pk.Key], row_mask: torch.Tensor, num_buckets: int):
    """The spill partition of one page: ``(bucket ids, perm, counts)``,
    bucket ids int32 (n,) (-1 for a dead row), perm int32 (n,) whose
    first ``counts.sum()`` entries are the live rows grouped by bucket
    in row order (the rest unspecified), counts int64 (K,).  CPU tensors
    take the plain version; CUDA tensors launch K11."""
    if not row_mask.is_cuda:
        return spill_partition_plain(keys, row_mask, num_buckets)
    global launches
    n = _check(keys, row_mask, num_buckets)
    build.require_cuda([row_mask] + [t for k in keys for t in k[:2]], "spill_partition")
    lib = build.library()
    for name in ("k11_blocks", "k11_scan_partials"):
        getattr(lib, name).restype = ctypes.c_longlong
        getattr(lib, name).argtypes = [ctypes.c_longlong]
    blocks = lib.k11_blocks(n)
    m = num_buckets * blocks
    dev = row_mask.device
    bids = torch.empty(n, dtype=torch.int32, device=dev)
    block_counts = torch.empty(m + 1, dtype=torch.int32, device=dev)
    partials = torch.empty(lib.k11_scan_partials(m), dtype=torch.int32, device=dev)
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(num_buckets, dtype=torch.int64, device=dev)
    fn = lib.k11_spill_partition
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p] + pk.C_ARGTYPES + [ctypes.c_int] + \
        [ctypes.c_void_p] * 6
    key_args = pk.c_args(keys) if keys else [0, None, None, None, None, None]
    err = fn(n, row_mask.data_ptr(), *key_args, num_buckets, bids.data_ptr(),
             block_counts.data_ptr(), partials.data_ptr(), perm.data_ptr(), counts.data_ptr(),
             build.stream_of(row_mask))
    build.check(err, "spill_partition")
    launches += 1
    return bids, perm, counts


def layout(cols: Sequence[Column], total: int) -> Tuple[List[Tuple[int, int]], int]:
    """Byte offsets ``(data, valid)`` of each column's segment in a
    gathered buffer of ``total`` rows, each segment aligned to
    ``ALIGN`` bytes (the padding between them is 0), and the buffer's
    size."""
    offs, pos = [], 0
    for data, valid in cols:
        row = data.element_size() * (data.shape[1] if data.dim() == 2 else 1)
        d_off = pos
        pos += -(-total * row // ALIGN) * ALIGN
        offs.append((d_off, pos))
        pos += -(-total * valid.element_size() // ALIGN) * ALIGN
    return offs, max(pos, ALIGN)


def _widths(cols: Sequence[Column], n: int) -> List[int]:
    out = []
    for data, valid in cols:
        width = data.element_size() * (data.shape[1] if data.dim() == 2 else 1)
        if data.shape[0] != n or valid.shape != (n,) or valid.dtype != torch.bool \
                or width not in (1, 4, 8, 16) or data.dim() > 2:
            raise ValueError(f"gather_columns: columns must be ({n},) or ({n}, 2) limbs")
        out.append(width)
    return out


def gather_columns_plain(cols: Sequence[Column], perm: torch.Tensor,
                         total: int) -> torch.Tensor:
    """The gathered buffer (uint8, laid out by :func:`layout`); the
    plain version."""
    offs, size = layout(cols, total)
    buf = torch.zeros(size, dtype=torch.uint8, device=perm.device)
    idx = perm[:total].to(torch.int64)
    for (data, valid), (d_off, v_off) in zip(cols, offs):
        d = data.index_select(0, idx).contiguous().view(torch.uint8).reshape(-1)
        buf[d_off:d_off + d.numel()] = d
        buf[v_off:v_off + total] = valid.index_select(0, idx).view(torch.uint8)
    return buf


def gather_columns(cols: Sequence[Column], perm: torch.Tensor, total: int) -> torch.Tensor:
    """Rows ``perm[:total]`` of each column, gathered into one contiguous
    uint8 buffer laid out by :func:`layout` (data, then validity, per
    column).  CPU tensors take the plain version; CUDA tensors launch
    ``k11_gather_columns`` (one launch per run of ``MAX_COLS``
    columns)."""
    widths = _widths(cols, perm.shape[0])
    if not perm.is_cuda:
        return gather_columns_plain(cols, perm, total)
    global gather_launches
    build.require_cuda([perm] + [t for c in cols for t in c], "gather_columns")
    offs, size = layout(cols, total)
    buf = torch.zeros(size, dtype=torch.uint8, device=perm.device)  # the padding is 0
    base = buf.data_ptr()
    fn = build.library().k11_gather_columns
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
    for c0 in range(0, len(cols), MAX_COLS):
        cs, os_ = cols[c0:c0 + MAX_COLS], offs[c0:c0 + MAX_COLS]
        err = fn(total, perm.data_ptr(), len(cs), build.ptrs(d.data_ptr() for d, _ in cs),
                 build.ptrs(v.data_ptr() for _, v in cs),
                 build.ptrs(base + d for d, _ in os_), build.ptrs(base + v for _, v in os_),
                 build.ints(widths[c0:c0 + MAX_COLS]), build.stream_of(perm))
        build.check(err, "gather_columns")
        gather_launches += 1
    return buf
