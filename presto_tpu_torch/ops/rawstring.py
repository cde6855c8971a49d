"""Raw (non-dictionary) VARCHAR values over fixed-width byte matrices.

Counterpart of ``presto_tpu/ops/rawstring.py``: a raw varchar column is
a zero-padded ``(capacity, W)`` uint8 matrix of UTF-8 bytes, ``W`` the
type's width.  ``encode_strings`` and ``decode_strings`` run on the
host; every other function runs one mode of K17 ``raw_string_eval``
(``kernels/raw_string_eval.py``), whose plain twin a CPU tensor takes.
Beside the reference's functions: ``like``, ``strpos``, ``codepoint``,
``starts_with``, ``ends_with`` and ``length`` in code points, which the
reference runs on the host (the port runs them in K17), ``isin``
against literal rows and ``select`` of rows by a mask.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from presto_tpu_torch.kernels import raw_string_eval as k17


def encode_strings(values, width: int) -> np.ndarray:
    """List of str/None -> (n, width) uint8, zero-padded, cut at the
    width (bytes, so a multibyte sequence may be cut)."""
    n = len(values)
    if n == 0:
        return np.zeros((0, width), dtype=np.uint8)
    enc = np.array([b"" if v is None else str(v).encode("utf-8") for v in values],
                   dtype=f"S{width}")  # numpy's bytes dtype cuts and zero-pads
    return np.ascontiguousarray(enc).view(np.uint8).reshape(n, width)


def decode_strings(data) -> list:
    """(n, W) uint8 -> list of str (padding stripped, a cut sequence as
    U+FFFD)."""
    arr = np.ascontiguousarray(np.asarray(data, dtype=np.uint8))
    return [row.tobytes().rstrip(b"\x00").decode("utf-8", errors="replace") for row in arr]


def encode_literal(s: str, width: int, device="cpu") -> torch.Tensor:
    """One literal as a (1, width) row."""
    return torch.from_numpy(encode_strings([s], width)).to(device)


def code_points(s: str) -> list:
    """A literal's code points, as K17's patterns and needles take them."""
    return [ord(c) for c in s]


def like_tokens(pattern: str) -> list:
    """A LIKE pattern as K17's tokens: ``_`` one code point, ``%`` any
    run, every other character itself (no escape character, as the
    reference's ``_like_to_regex``)."""
    return [k17.ANY_RUN if c == "%" else k17.ANY_ONE if c == "_" else ord(c) for c in pattern]


def lengths(data: torch.Tensor) -> torch.Tensor:
    """Byte length per row (padding is the only NUL source)."""
    return k17.raw_string_eval(k17.LEN, data)


def char_lengths(data: torch.Tensor) -> torch.Tensor:
    """Length per row in code points (SQL ``length``)."""
    return k17.raw_string_eval(k17.LEN, data, flag=True)


def compare(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lt, eq) lexicographic over rows; zero padding sorts shortest
    first.  ``b`` may be one row (a literal)."""
    s = k17.raw_string_eval(k17.CMP, a, b, op="sign")
    return s < 0, s == 0


def compare_op(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    """One comparison (eq, ne, lt, le, gt, ge) of each row of ``a``
    against ``b``'s (or its one row)."""
    return k17.raw_string_eval(k17.CMP, a, b, op=op)


def isin(a: torch.Tensor, lits: torch.Tensor) -> torch.Tensor:
    """Rows equal to any literal row of ``lits``, ``MAX_IN`` a launch."""
    hit = None
    for lo in range(0, lits.shape[0], k17.MAX_IN):
        got = k17.raw_string_eval(k17.IN, a, lits[lo:lo + k17.MAX_IN])
        hit = got if hit is None else hit | got
    return hit


def substr(data: torch.Tensor, start: int, length: Optional[int] = None) -> torch.Tensor:
    """1-based byte slice, re-padded to the column width."""
    return k17.raw_string_eval(k17.SUBSTR, data, start=start, length=length)


def substr_chars(data: torch.Tensor, start: int, length: Optional[int] = None) -> torch.Tensor:
    """1-based substring by UTF-8 character (a byte that is neither NUL
    nor a continuation starts one), re-padded to the column width."""
    return k17.raw_string_eval(k17.SUBSTR, data, start=start, length=length, flag=True)


def change_case(data: torch.Tensor, upper: bool) -> torch.Tensor:
    """ASCII + Latin-1 (the 0xC3 page, not ÷ and ×) case mapping."""
    return k17.raw_string_eval(k17.CASE_MAP, data, flag=upper)


def concat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise concatenation, output width Wa + Wb; ``b`` may be one
    row (a literal)."""
    return k17.raw_string_eval(k17.CONCAT, a, b)


def hash_bytes(data: torch.Tensor) -> torch.Tensor:
    """One int64 hash lane per row: FNV-1a over the static width,
    masked to 63 bits (the raw-string key lane)."""
    return k17.raw_string_eval(k17.HASH, data)


def pack_lanes(data: torch.Tensor) -> torch.Tensor:
    """(n, W) bytes -> (n, ceil(W/8)) int64 lanes whose lexicographic
    order as signed int64 is the bytes' order."""
    return k17.raw_string_eval(k17.PACK, data)


def unpack_lanes(lanes: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of :func:`pack_lanes`: (n, width) uint8."""
    return k17.raw_string_eval(k17.UNPACK, lanes.contiguous(), width=width)


def like(data: torch.Tensor, pattern: str) -> torch.Tensor:
    return k17.raw_string_eval(k17.LIKE, data, tokens=like_tokens(pattern))


def starts_with(data: torch.Tensor, prefix: str) -> torch.Tensor:
    return k17.raw_string_eval(k17.PREFIX, data, tokens=code_points(prefix))


def ends_with(data: torch.Tensor, suffix: str) -> torch.Tensor:
    return k17.raw_string_eval(k17.SUFFIX, data, tokens=code_points(suffix))


def strpos(data: torch.Tensor, needle: str) -> torch.Tensor:
    """1-based character position of ``needle``'s first occurrence, 0
    when absent (Python's ``find`` + 1 on the decoded row)."""
    return k17.raw_string_eval(k17.STRPOS, data, tokens=code_points(needle))


def codepoint(data: torch.Tensor) -> torch.Tensor:
    """The first character's code point, 0 for an empty row."""
    return k17.raw_string_eval(k17.CODEPOINT, data)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor, width: int) -> torch.Tensor:
    """``a``'s row where ``mask`` holds, else ``b``'s (either may be one
    row), both padded or cut to ``width``."""
    return k17.raw_string_eval(k17.SELECT, a, b, mask=mask, width=width)


def literal_rows(values: Sequence[str], width: int, device) -> torch.Tensor:
    """Literal rows, each at least as wide as its bytes and ``width``."""
    w = max([width] + [len(str(v).encode("utf-8")) for v in values])
    return torch.from_numpy(encode_strings(list(values), w)).to(device)
