"""K17 ``raw_string_eval``: raw (non-dictionary) VARCHAR values.

A raw varchar column is a zero-padded ``(n, W)`` uint8 matrix of UTF-8
bytes, ``W`` the type's width (the reference's ``ops/rawstring.py``).
:func:`raw_string_eval` runs one mode over such a matrix, one thread a
row on the card (``csrc/raw_string_eval.cu``); a CPU tensor takes the
mode's plain torch twin here.  The modes:

- CMP: a row against a second matrix (one row each, or one row for
  every row: a literal) of another width, zero padding sorting
  shortest first (``compare``), as one comparison or as a sign;
- IN: a row equal to any of up to ``MAX_IN`` literal rows;
- SUBSTR: ``substr_chars`` (1-based, counting code points) or the
  byte slice ``substr``, re-padded to the column's width;
- CASE_MAP: ``change_case``, ASCII and the Latin-1 letters of the 0xC3
  page (not ÷ and ×);
- CONCAT: ``concat``, output width ``Wa + Wb``;
- LEN: the length in code points, or in bytes (``lengths``);
- STRPOS, CODEPOINT, LIKE, PREFIX, SUFFIX: ``strpos`` (1-based, 0 when
  absent), ``codepoint`` (of the first character, 0 when empty), LIKE
  (a pattern of code points, ``_`` one code point, ``%`` any run),
  ``starts_with``, ``ends_with``;
- PACK, UNPACK: ``pack_lanes`` / ``unpack_lanes``, big-endian 8-byte
  lanes with the sign bit flipped, so lanes compare as signed int64 in
  the bytes' order;
- HASH: ``hash_bytes``, FNV-1a over the whole width, masked to 63 bits;
- SELECT: a row-wise choice between two matrices by a mask (CASE,
  coalesce, nullif, greatest and least), padded or cut to one width.

The functions that read characters decode the row as the reference's
host path does (``bytes.rstrip(b"\\0").decode("utf-8",
errors="replace")``): a character starts at each byte that is not a
continuation byte (``0b10xxxxxx``), up to the last nonzero byte, and
spans the continuation bytes after it; a sequence with fewer
continuation bytes than its lead announces (one cut at the width)
decodes to U+FFFD.  Data that Python's encoder wrote, cut at a width or
joined by CONCAT, decodes the same way under both rules.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from presto_tpu_torch.kernels import build

# modes: keep in step with csrc/raw_string_eval.cu
CMP, IN, SUBSTR, CASE_MAP, CONCAT, LEN, STRPOS, CODEPOINT, LIKE, PREFIX, SUFFIX, PACK, \
    UNPACK, HASH, SELECT = range(15)
MODE_NAMES = ("cmp", "in", "substr", "case_map", "concat", "len", "strpos", "codepoint",
              "like", "prefix", "suffix", "pack", "unpack", "hash", "select")
CMP_OPS = ("eq", "ne", "lt", "le", "gt", "ge", "sign")
# LIKE's wildcard tokens beside the pattern's code points
ANY_ONE, ANY_RUN = -1, -2
MAX_WIDTH = 1024  # csrc/raw_string_eval.cu K17_MAX_WIDTH
MAX_TOKENS = 256  # K17_MAX_TOKENS: a pattern's or needle's code points
MAX_IN = 64  # K17_MAX_IN
REPLACEMENT = 0xFFFD
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1
_FNV_OFFSET = 0xCBF29CE484222325 - (1 << 64)
_FNV_PRIME = 0x100000001B3

launches = 0
#: launches by mode name
mode_launches: dict = {}


# -- plain twins ---------------------------------------------------------------

def _pad(x: torch.Tensor, w: int) -> torch.Tensor:
    """Rows zero-padded or cut to width ``w`` (the reference's ``_pad_to``)."""
    have = x.shape[1]
    if have == w:
        return x
    if have > w:
        return x[:, :w]
    return torch.cat([x, torch.zeros((x.shape[0], w - have), dtype=x.dtype,
                                     device=x.device)], 1)


def _rows(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.expand(n, -1) if x.shape[0] == 1 and n != 1 else x


def cmp_sign_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """-1, 0 or 1 per row: the first differing byte, zero padding to the
    wider width (``compare``)."""
    w = max(a.shape[1], b.shape[1])
    a2, b2 = _pad(a, w), _pad(_rows(b, a.shape[0]), w)
    diff = a2 != b2
    any_diff = diff.any(1)
    first = torch.argmax(diff.to(torch.int8), 1, keepdim=True)
    av = torch.gather(a2, 1, first)[:, 0]
    bv = torch.gather(b2, 1, first)[:, 0]
    lt = any_diff & (av < bv)
    return torch.where(lt, -1, torch.where(any_diff, 1, 0)).to(torch.int8)


def _op_of_sign(s: torch.Tensor, op: str) -> torch.Tensor:
    if op == "sign":
        return s
    return {"eq": s == 0, "ne": s != 0, "lt": s < 0, "le": s <= 0, "gt": s > 0,
            "ge": s >= 0}[op]


def isin_plain(a: torch.Tensor, lits: torch.Tensor) -> torch.Tensor:
    hit = torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
    for j in range(lits.shape[0]):
        hit |= cmp_sign_plain(a, lits[j:j + 1]) == 0
    return hit


def _compact(data: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Each row's kept values moved to its front in order, zeros after
    (a stable argsort of ``~keep``, the reference's compaction)."""
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    vals = torch.gather(data, 1, order)
    kept = torch.gather(keep, 1, order)
    return torch.where(kept, vals, torch.zeros_like(vals))


def substr_plain(a: torch.Tensor, start: int, length: Optional[int], chars: bool):
    w = a.shape[1]
    s = max(start - 1, 0)
    if not chars:  # the byte slice, re-padded
        end = w if length is None else min(s + length, w)
        return _pad(a[:, s:max(end, s)], w)
    is_byte = a != 0
    is_start = is_byte & ((a & 0xC0) != 0x80)
    char_idx = torch.cumsum(is_start.to(torch.int32), 1) - 1
    keep = is_byte & (char_idx >= s)
    if length is not None:
        keep &= char_idx < s + length
    return _compact(a, keep)


def case_map_plain(a: torch.Tensor, upper: bool) -> torch.Tensor:
    prev = torch.cat([torch.zeros_like(a[:, :1]), a[:, :-1]], 1)
    after_c3 = prev == 0xC3
    if upper:
        ascii_hit = (a >= ord("a")) & (a <= ord("z"))
        lat = after_c3 & (a >= 0xA0) & (a <= 0xBE) & (a != 0xB7)
        return torch.where(ascii_hit | lat, a - 32, a)
    ascii_hit = (a >= ord("A")) & (a <= ord("Z"))
    lat = after_c3 & (a >= 0x80) & (a <= 0x9E) & (a != 0x97)
    return torch.where(ascii_hit | lat, a + 32, a)


def byte_lengths_plain(a: torch.Tensor) -> torch.Tensor:
    return (a != 0).sum(1, dtype=torch.int64)


def concat_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n = a.shape[0]
    b = _rows(b, n)
    wa, wb = a.shape[1], b.shape[1]
    w = wa + wb
    la = byte_lengths_plain(a)[:, None]
    lb = byte_lengths_plain(b)[:, None]
    j = torch.arange(w, device=a.device)[None, :]
    from_b = j >= la
    bj = torch.clamp(j - la, 0, wb - 1)
    b_vals = torch.gather(b, 1, bj)
    in_b = from_b & (j - la < lb)
    return torch.where(in_b, b_vals, torch.where(from_b, torch.zeros_like(b_vals), _pad(a, w)))


def hash_plain(a: torch.Tensor) -> torch.Tensor:
    h = torch.full((a.shape[0],), _FNV_OFFSET, dtype=torch.int64, device=a.device)
    for j in range(a.shape[1]):
        h = (h ^ a[:, j].to(torch.int64)) * _FNV_PRIME
    return h & _I64_MAX


def pack_plain(a: torch.Tensor) -> torch.Tensor:
    k = -(-a.shape[1] // 8)
    p = _pad(a, 8 * k).to(torch.int64)
    lanes = []
    for c in range(k):
        lane = torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
        for j in range(8):
            lane = (lane << 8) | p[:, 8 * c + j]
        lanes.append(lane ^ _I64_MIN)
    return torch.stack(lanes, 1)


def unpack_plain(lanes: torch.Tensor, width: int) -> torch.Tensor:
    u = lanes ^ _I64_MIN
    cols = [(u[:, c] >> (8 * (7 - j))) & 0xFF for c in range(lanes.shape[1]) for j in range(8)]
    return torch.stack(cols, 1)[:, :width].to(torch.uint8)


def select_plain(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor, width: int):
    n = mask.shape[0]
    return torch.where(mask[:, None], _pad(_rows(a, n), width), _pad(_rows(b, n), width))


def decode_units(a: torch.Tensor):
    """``(code points (n, W) int32 at each row's front, counts (n,))``:
    the characters of each row under the module's decoding rule."""
    n, w = a.shape
    dev = a.device
    pos = torch.arange(w, device=dev)
    nz = a != 0
    length = torch.where(nz.any(1), w - torch.argmax(nz.flip(1).to(torch.int8), 1),
                         torch.zeros(n, dtype=torch.int64, device=dev))
    inrow = pos[None, :] < length[:, None]
    cont = ((a & 0xC0) == 0x80) & inrow
    start = inrow & ~cont
    # run of continuation bytes that begins at each position
    run = torch.zeros((n, w + 1), dtype=torch.int64, device=dev)
    for j in range(w - 1, -1, -1):
        run[:, j] = torch.where(cont[:, j], run[:, j + 1] + 1, 0)
    follow = run[:, 1:]
    x = a.to(torch.int64)
    nxt = [torch.cat([x[:, k:], torch.zeros((n, k), dtype=torch.int64, device=dev)], 1)
           for k in (1, 2, 3)]
    need = torch.where(x < 0x80, 0, torch.where(x >= 0xF8, -1, torch.where(
        x >= 0xF0, 3, torch.where(x >= 0xE0, 2, torch.where(x >= 0xC0, 1, 0)))))
    cp = torch.where(need == 0, x, torch.where(need == 1, x & 0x1F, torch.where(
        need == 2, x & 0x0F, x & 0x07)))
    for k in (1, 2, 3):
        cp = torch.where(need >= k, (cp << 6) | (nxt[k - 1] & 0x3F), cp)
    cp = torch.where(follow == need, cp, REPLACEMENT)
    return _compact(cp.to(torch.int32), start), start.sum(1)


def length_plain(a: torch.Tensor, chars: bool) -> torch.Tensor:
    if not chars:
        return byte_lengths_plain(a)
    return decode_units(a)[1]


def codepoint_plain(a: torch.Tensor) -> torch.Tensor:
    cps, count = decode_units(a)
    return torch.where(count > 0, cps[:, 0].to(torch.int64), 0)


def strpos_plain(a: torch.Tensor, needle: Sequence[int]) -> torch.Tensor:
    cps, count = decode_units(a)
    n, w = cps.shape
    m = len(needle)
    if m == 0:
        return torch.ones(n, dtype=torch.int64, device=a.device)
    if m > w:
        return torch.zeros(n, dtype=torch.int64, device=a.device)
    s = torch.arange(w - m + 1, device=a.device)
    hit = (s[None, :] + m) <= count[:, None]
    for t, c in enumerate(needle):
        hit &= cps[:, t:t + w - m + 1] == c
    first = torch.argmax(hit.to(torch.int8), 1)
    return torch.where(hit.any(1), first + 1, 0)


def affix_plain(a: torch.Tensor, needle: Sequence[int], suffix: bool) -> torch.Tensor:
    cps, count = decode_units(a)
    n, w = cps.shape
    m = len(needle)
    ok = count >= m
    if m == 0:
        return ok
    if m > w:
        return torch.zeros(n, dtype=torch.bool, device=a.device)
    base = torch.clamp(count - m, min=0) if suffix else torch.zeros_like(count)
    for t, c in enumerate(needle):
        ok &= torch.gather(cps, 1, (base + t)[:, None])[:, 0] == c
    return ok


def like_plain(a: torch.Tensor, tokens: Sequence[int]) -> torch.Tensor:
    """LIKE as a set of reachable text positions per row, token by
    token: a code point or ``_`` steps one character, ``%`` reaches
    every later position; the row matches where its length is
    reachable at the end."""
    cps, count = decode_units(a)
    n, w = cps.shape
    pos = torch.arange(w + 1, device=a.device)
    within = pos[None, :] <= count[:, None]
    reach = torch.zeros((n, w + 1), dtype=torch.bool, device=a.device)
    reach[:, 0] = True
    for tok in tokens:
        if tok == ANY_RUN:
            reach = (torch.cummax(reach.to(torch.int8), 1).values > 0) & within
            continue
        step = reach[:, :w] & (pos[None, :w] < count[:, None])
        if tok != ANY_ONE:
            step &= cps == tok
        reach = torch.cat([torch.zeros_like(reach[:, :1]), step], 1)
    return torch.gather(reach, 1, count[:, None])[:, 0]


# -- the wrapper -----------------------------------------------------------------

def _check_matrix(x: torch.Tensor, what: str) -> None:
    if x.dim() != 2 or x.dtype != torch.uint8:
        raise ValueError(f"raw_string_eval: {what} must be (rows, W) uint8")
    if not 1 <= x.shape[1] <= MAX_WIDTH:
        raise ValueError(f"raw_string_eval: {what} width {x.shape[1]} past the kernel's "
                         f"{MAX_WIDTH}")


def raw_string_eval(mode: int, a: torch.Tensor, b: Optional[torch.Tensor] = None,
                    tokens: Sequence[int] = (), mask: Optional[torch.Tensor] = None,
                    op: str = "eq", start: int = 1, length: Optional[int] = None,
                    flag: bool = False, width: int = 0) -> torch.Tensor:
    """One K17 mode over the ``(n, W)`` uint8 rows ``a`` (PACK's
    inverse, UNPACK, takes ``(n, k)`` int64 lanes).  ``b``: CMP's and
    CONCAT's second matrix (``n`` rows, or one), IN's literal rows,
    SELECT's second matrix; ``tokens``: LIKE's pattern (code points,
    :data:`ANY_ONE`, :data:`ANY_RUN`), a needle's code points;
    ``mask``: SELECT's choice (``a`` where true); ``op``: CMP's
    comparison (``"sign"``: -1, 0 or 1 as int8); ``start``/``length``:
    SUBSTR's; ``flag``: SUBSTR and LEN count code points, CASE_MAP maps
    to upper case; ``width``: UNPACK's and SELECT's output width.  CPU
    tensors take the plain twin; CUDA tensors launch the kernel."""
    if mode == UNPACK:
        if a.dim() != 2 or a.dtype != torch.int64 or not 1 <= width <= 8 * a.shape[1] \
                or width > MAX_WIDTH:
            raise ValueError("raw_string_eval: UNPACK takes (n, k) int64 lanes, width <= 8k")
    else:
        _check_matrix(a, "a")
    if b is not None:
        _check_matrix(b, "b")
        rows = mask.shape[0] if mode == SELECT and mask is not None else a.shape[0]
        if mode in (CMP, CONCAT, SELECT) and b.shape[0] not in (1, rows):
            raise ValueError("raw_string_eval: b must have one row or a's rows")
        if mode == IN and not 1 <= b.shape[0] <= MAX_IN:
            raise ValueError(f"raw_string_eval: IN over 1 to {MAX_IN} literals")
    if mode in (CMP, IN, CONCAT, SELECT) and b is None:
        raise ValueError(f"raw_string_eval: {MODE_NAMES[mode]} needs b")
    if len(tokens) > MAX_TOKENS:
        raise ValueError(f"raw_string_eval: a pattern of more than {MAX_TOKENS} code points")
    if mode == SELECT:
        if mask is None or mask.dtype != torch.bool or mask.dim() != 1 \
                or a.shape[0] not in (1, mask.shape[0]) \
                or not 1 <= width <= MAX_WIDTH:
            raise ValueError("raw_string_eval: SELECT takes an (n,) bool mask and a width")
    if mode == CMP and op not in CMP_OPS:
        raise ValueError(f"raw_string_eval: comparison {op}")
    if not a.is_cuda:
        return raw_string_eval_plain(mode, a, b, tokens, mask, op, start, length, flag, width)
    return _launch(mode, a, b, tokens, mask, op, start, length, flag, width)


# rows a call of a twin takes at once (the modes are row-wise; the
# character modes hold a few (rows, W) int32 tensors)
PLAIN_CHUNK = 1 << 20


def raw_string_eval_plain(mode: int, a: torch.Tensor, b: Optional[torch.Tensor] = None,
                          tokens: Sequence[int] = (), mask: Optional[torch.Tensor] = None,
                          op: str = "eq", start: int = 1, length: Optional[int] = None,
                          flag: bool = False, width: int = 0) -> torch.Tensor:
    """The plain twin of :func:`raw_string_eval` (the same arguments) on
    any device, ``PLAIN_CHUNK`` rows at a time."""
    n = mask.shape[0] if mode == SELECT else a.shape[0]
    if n <= PLAIN_CHUNK:
        return _plain(mode, a, b, tokens, mask, op, start, length, flag, width)

    def rows(x, lo, hi):
        return x if x is None or x.shape[0] == 1 or (mode == IN and x is b) else x[lo:hi]

    return torch.cat([_plain(mode, rows(a, lo, lo + PLAIN_CHUNK), rows(b, lo, lo + PLAIN_CHUNK),
                             tokens, rows(mask, lo, lo + PLAIN_CHUNK), op, start, length, flag,
                             width) for lo in range(0, n, PLAIN_CHUNK)])


def _plain(mode, a, b, tokens, mask, op, start, length, flag, width):
    if mode == CMP:
        return _op_of_sign(cmp_sign_plain(a, b), op)
    if mode == IN:
        return isin_plain(a, b)
    if mode == SUBSTR:
        return substr_plain(a, start, length, flag)
    if mode == CASE_MAP:
        return case_map_plain(a, flag)
    if mode == CONCAT:
        return concat_plain(a, b)
    if mode == LEN:
        return length_plain(a, flag)
    if mode == STRPOS:
        return strpos_plain(a, tokens)
    if mode == CODEPOINT:
        return codepoint_plain(a)
    if mode == LIKE:
        return like_plain(a, tokens)
    if mode in (PREFIX, SUFFIX):
        return affix_plain(a, tokens, mode == SUFFIX)
    if mode == PACK:
        return pack_plain(a)
    if mode == UNPACK:
        return unpack_plain(a, width)
    if mode == HASH:
        return hash_plain(a)
    if mode == SELECT:
        return select_plain(mask, a, b, width)
    raise ValueError(f"raw_string_eval: mode {mode}")


def _launch(mode, a, b, tokens, mask, op, start, length, flag, width):
    global launches
    n = a.shape[0] if mode != SELECT else mask.shape[0]
    dev = a.device
    tensors = [a] + ([b] if b is not None else []) + ([mask] if mask is not None else [])
    build.require_cuda(tensors, "raw_string_eval")
    wa = a.shape[1] * (8 if mode == UNPACK else 1)
    if mode == CMP:
        out = torch.empty(n, dtype=torch.int8 if op == "sign" else torch.bool, device=dev)
    elif mode in (IN, LIKE, PREFIX, SUFFIX):
        out = torch.empty(n, dtype=torch.bool, device=dev)
    elif mode in (LEN, STRPOS, CODEPOINT, HASH):
        out = torch.empty(n, dtype=torch.int64, device=dev)
    elif mode == PACK:
        out = torch.empty((n, -(-wa // 8)), dtype=torch.int64, device=dev)
    else:
        wo = {SUBSTR: wa, CASE_MAP: wa, CONCAT: wa + (b.shape[1] if b is not None else 0),
              UNPACK: width, SELECT: width}[mode]
        out = torch.empty((n, wo), dtype=torch.uint8, device=dev)
    tok = None
    if tokens:
        tok = torch.tensor(list(tokens), dtype=torch.int32).to(dev, non_blocking=True)
    wo = out.shape[1] if out.dim() == 2 else 0
    p0 = CMP_OPS.index(op) if mode == CMP else start
    p1 = 0 if length is None else length
    flags = int(flag) | (int(length is not None) << 1)
    fn = build.library().k17_raw_string_eval
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    err = fn(mode, p0, p1, flags, n, a.data_ptr(), wa, a.shape[0],
             None if b is None else b.data_ptr(), 0 if b is None else b.shape[1],
             0 if b is None else b.shape[0], None if tok is None else tok.data_ptr(),
             len(tokens), None if mask is None else mask.data_ptr(), out.data_ptr(), wo,
             build.stream_of(a))
    build.check(err, "raw_string_eval")
    launches += 1
    name = MODE_NAMES[mode]
    mode_launches[name] = mode_launches.get(name, 0) + 1
    return out
