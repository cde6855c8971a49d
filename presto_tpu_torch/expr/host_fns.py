"""Host-side scalar helpers: string transforms and literal conversions.

Torch-free copies of the reference's host helpers
(``presto_tpu/expr/compile.py``): the per-value transforms of
``STRING_TRANSFORM_FNS``, which derive a dictionary's values while
the device passes codes through unchanged, and the conversions the
binder folds at bind time when every argument is a literal
(``date_parse``, ``from_iso8601_date``, ``xxhash64``,
``levenshtein_distance``, ``json_size``).
"""

from __future__ import annotations

import re

from presto_tpu_torch.expr.ir import Literal

# fns whose result is a per-value string transform of a single string
# column: codes pass through, only the dictionary's values change
# (DictionaryAwarePageProjection analog). Transforms may return None
# (SQL NULL) — compile() folds a null-LUT into validity.
STRING_TRANSFORM_FNS = frozenset({
    "substr", "upper", "lower", "trim", "ltrim", "rtrim", "reverse",
    "char2hexint",
    "regexp_extract", "regexp_replace", "replace", "split_part",
    "lpad", "rpad", "concat", "json_extract", "json_extract_scalar",
    "url_extract_host", "url_extract_path", "url_extract_protocol",
    "url_extract_query", "translate", "normalize", "soundex",
    "url_encode", "url_decode", "json_format", "json_parse",
    "md5_hex", "sha1_hex", "sha256_hex",
})


# MySQL date_format/date_parse pattern -> python strftime/strptime
# (DateTimeFunctions.java's JodaTime DateTimeFormat table)
_MYSQL_FMT = {
    "Y": "%Y", "y": "%y", "m": "%m", "c": "%-m", "d": "%d", "e": "%-d",
    "j": "%j", "a": "%a", "W": "%A", "b": "%b", "M": "%B", "w": "%w",
    "H": "%H", "k": "%-H", "h": "%I", "I": "%I", "i": "%M", "s": "%S",
    "S": "%S", "f": "%f", "p": "%p", "T": "%H:%M:%S", "r": "%I:%M:%S %p",
    "%": "%%",
    # %-m / %-d / %-H (non-padded c/e/k) are glibc strftime extensions;
    # strptime ignores the flag, so parsing accepts both forms
}

def _mysql_to_strftime(fmt: str, for_parse: bool = False) -> str:
    out, i = [], 0
    while i < len(fmt):
        ch = fmt[i]
        if ch == "%" and i + 1 < len(fmt):
            code = fmt[i + 1]
            got = _MYSQL_FMT.get(code)
            if got is None:
                raise ValueError(f"unsupported date format code %{code}")
            if for_parse:
                # strptime rejects the glibc no-pad flag but already
                # accepts non-padded numbers under the plain codes
                got = got.replace("%-", "%")
            out.append(got)
            i += 2
        else:
            out.append(ch.replace("%", "%%"))
            i += 1
    return "".join(out)


_INT_RX = re.compile(r"^[+-]?\d+$")
_FLOAT_RX = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")
_I64_LO, _I64_HI = -(1 << 63), (1 << 63) - 1


def parse_number_strict(v, to_double: bool):
    """varchar -> number with the reference's accepted syntax only (no
    python extras like '1_0' or padding) and int64 range enforcement;
    None for anything else (a copy of the reference's
    ``parse_number_strict``, which the binder's literal fold uses)."""
    if not isinstance(v, str):
        return None
    if to_double:
        if _FLOAT_RX.match(v):
            return float(v)
        if v in ("Infinity", "-Infinity", "+Infinity", "NaN"):
            return float(v.replace("Infinity", "inf"))
        return None
    if not _INT_RX.match(v):
        return None
    n = int(v)
    return n if _I64_LO <= n <= _I64_HI else None


def mysql_datetime_micros(v: str, fmt: str):
    """date_parse's conversion, shared by the bind-time literal fold
    and the column LUT so they cannot diverge.  None on parse failure
    (deviation: the reference raises)."""
    import datetime as _dt

    try:
        ts = _dt.datetime.strptime(v, _mysql_to_strftime(fmt, for_parse=True))
    except ValueError:
        return None
    delta = ts - _dt.datetime(1970, 1, 1)
    return ((delta.days * 86400 + delta.seconds) * 1_000_000
            + delta.microseconds)  # exact, no float round-trip


def iso_date_days(v: str):
    """from_iso8601_date's epoch-day conversion (shared fold/LUT)."""
    import datetime as _dt

    try:
        return _dt.date.fromisoformat(v).toordinal() - 719163
    except ValueError:
        return None


def xxh64_signed(data: bytes) -> int:
    """xxhash64 wrapped into BIGINT's signed range (shared fold/LUT)."""
    h = _xxh64(data)
    return h - (1 << 64) if h >= (1 << 63) else h


def _levenshtein(a: str, b: str) -> int:
    """Classic DP edit distance (StringFunctions.java#levenshteinDistance)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _xxh64(data: bytes, seed: int = 0) -> int:
    """xxHash64 (public spec, xxhash.com) — host-side over dictionary
    values, one device gather for the column form."""
    P1, P2, P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
    P4, P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5
    M = (1 << 64) - 1

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & M

    n = len(data)
    i = 0
    if n >= 32:
        v1 = (seed + P1 + P2) & M
        v2 = (seed + P2) & M
        v3 = seed & M
        v4 = (seed - P1) & M
        while i + 32 <= n:
            for k, v in enumerate((v1, v2, v3, v4)):
                lane = int.from_bytes(data[i + 8 * k:i + 8 * k + 8], "little")
                v = (v + lane * P2) & M
                v = (rotl(v, 31) * P1) & M
                if k == 0:
                    v1 = v
                elif k == 1:
                    v2 = v
                elif k == 2:
                    v3 = v
                else:
                    v4 = v
            i += 32
        h = (rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18)) & M
        for v in (v1, v2, v3, v4):
            v = (rotl((v * P2) & M, 31) * P1) & M
            h = ((h ^ v) * P1 + P4) & M
    else:
        h = (seed + P5) & M
    h = (h + n) & M
    while i + 8 <= n:
        lane = int.from_bytes(data[i:i + 8], "little")
        h ^= (rotl((lane * P2) & M, 31) * P1) & M
        h = (rotl(h, 27) * P1 + P4) & M
        i += 8
    if i + 4 <= n:
        h ^= (int.from_bytes(data[i:i + 4], "little") * P1) & M
        h = (rotl(h, 23) * P2 + P3) & M
        i += 4
    while i < n:
        h ^= (data[i] * P5) & M
        h = (rotl(h, 11) * P1) & M
        i += 1
    h ^= h >> 33
    h = (h * P2) & M
    h ^= h >> 29
    h = (h * P3) & M
    h ^= h >> 32
    return h


def _json_path_lookup(doc: str, path: str):
    """Tiny JSONPath subset: $, .name, [idx] (reference:
    operator/scalar/JsonExtract.java's path engine).
    Returns (found, value) so a JSON null VALUE is distinguishable
    from a missing path."""
    import json as _json

    try:
        cur = _json.loads(doc)
    except Exception:
        return False, None
    if not path.startswith("$"):
        return False, None
    i = 1
    toks = re.findall(r"\.([A-Za-z_][A-Za-z0-9_]*)|\[(\d+)\]", path[i:])
    consumed = sum(len(f".{a}") if a else len(f"[{b}]") for a, b in toks)
    if consumed != len(path) - 1:
        return False, None
    for name, idx in toks:
        if name:
            if not isinstance(cur, dict) or name not in cur:
                return False, None
            cur = cur[name]
        else:
            j = int(idx)
            if not isinstance(cur, list) or j >= len(cur):
                return False, None
            cur = cur[j]
    return True, cur


def _json_path_get(doc: str, path: str):
    found, cur = _json_path_lookup(doc, path)
    if not found:
        return None
    return cur


def _string_transform(e: "Call"):
    """value -> Optional[value] host transform for STRING_TRANSFORM_FNS,
    plus a hashable cache key; None if ``e`` is not such a call."""
    fn = e.fn
    lits = tuple(a.value for a in e.args if isinstance(a, Literal))
    key = (fn,) + lits

    if fn == "substr":
        start = e.args[1].value
        length = e.args[2].value if len(e.args) > 2 else None
        end = None if length is None else start - 1 + length
        return lambda v: v[start - 1 : end], key
    if fn in ("upper", "lower", "trim", "ltrim", "rtrim", "reverse"):
        f = {"upper": str.upper, "lower": str.lower, "trim": str.strip,
             "ltrim": str.lstrip, "rtrim": str.rstrip,
             "reverse": lambda s: s[::-1]}[fn]
        return f, key
    if fn == "char2hexint":
        # teradata: utf-16be code units as uppercase hex
        return lambda v: "".join(f"{ord(ch):04X}" for ch in v), key
    if fn == "regexp_extract":
        rx = re.compile(e.args[1].value)
        group = int(e.args[2].value) if len(e.args) > 2 else 0

        def f(v, rx=rx, g=group):
            m = rx.search(v)
            return m.group(g) if m else None

        return f, key
    if fn == "regexp_replace":
        rx = re.compile(e.args[1].value)
        repl = e.args[2].value if len(e.args) > 2 else ""
        # $N -> \g<N> (plain \N would make $0 a NUL octal escape)
        py_repl = re.sub(r"\$(\d+)", r"\\g<\1>", repl)
        return lambda v: rx.sub(py_repl, v), key
    if fn == "replace":
        frm = e.args[1].value
        to = e.args[2].value if len(e.args) > 2 else ""
        return lambda v: v.replace(frm, to), key
    if fn == "translate":
        # chars of `from` map positionally to `to`; unpaired chars drop
        # (StringFunctions.java#translate)
        frm = e.args[1].value
        to = e.args[2].value
        table: dict = {}
        for i, f in enumerate(frm):
            # first occurrence of a duplicated `from` char wins
            table.setdefault(ord(f), to[i] if i < len(to) else None)
        return lambda v: v.translate(table), key
    if fn == "normalize":
        form = e.args[1].value if len(e.args) > 1 else "NFC"
        import unicodedata

        return lambda v: unicodedata.normalize(form, v), key
    if fn == "url_encode":
        # application/x-www-form-urlencoded (the reference's
        # URLEncoder): space -> '+', '*' '-' '.' '_' stay bare
        from urllib.parse import quote_plus

        # quote_plus hard-codes '~' as safe; URLEncoder encodes it
        return lambda v: quote_plus(v, safe="*-._").replace("~", "%7E"), key
    if fn == "url_decode":
        from urllib.parse import unquote_plus

        return lambda v: unquote_plus(v), key
    if fn in ("json_format", "json_parse"):
        # both normalize JSON text (the engine's JSON values are
        # varchar); invalid input -> NULL (deviation: json_parse raises
        # in the reference)
        import json as _json

        def jf(v):
            try:
                return _json.dumps(_json.loads(v), separators=(",", ":"))
            except Exception:
                return None

        return jf, key
    if fn in ("md5_hex", "sha1_hex", "sha256_hex"):
        import hashlib

        algo = fn[:-4]

        def hx(v, algo=algo):
            # reference to_hex (BaseEncoding.base16) is UPPERCASE
            return hashlib.new(algo, v.encode()).hexdigest().upper()

        return hx, key
    if fn == "soundex":
        # classic American Soundex (StringFunctions.java#soundex)
        codes = {}
        for group, digit in (("BFPV", "1"), ("CGJKQSXZ", "2"),
                             ("DT", "3"), ("L", "4"), ("MN", "5"),
                             ("R", "6")):
            for ch in group:
                codes[ch] = digit

        def sdx(v, codes=codes):
            s = [c for c in v.upper() if c.isalpha()]
            if not s:
                return None
            out = s[0]
            prev = codes.get(s[0], "")
            for c in s[1:]:
                d = codes.get(c, "")
                if d and d != prev:
                    out += d
                if c not in "HW":
                    prev = d
            return (out + "000")[:4]

        return sdx, key
    if fn == "split_part":
        delim, n = e.args[1].value, int(e.args[2].value)

        def f(v, delim=delim, n=n):
            parts = v.split(delim)
            return parts[n - 1] if 0 < n <= len(parts) else None

        return f, key
    if fn in ("lpad", "rpad"):
        n = int(e.args[1].value)
        pad = e.args[2].value if len(e.args) > 2 else " "
        if fn == "lpad":
            def f(v, n=n, pad=pad):
                if len(v) >= n:
                    return v[:n]
                fill = (pad * n)[: n - len(v)]
                return fill + v
        else:
            def f(v, n=n, pad=pad):
                if len(v) >= n:
                    return v[:n]
                return v + (pad * n)[: n - len(v)]
        return f, key
    if fn == "concat":
        # one string column + literals in any positions
        parts = []
        for a in e.args:
            parts.append(a.value if isinstance(a, Literal) else None)
        if parts.count(None) != 1:
            return None

        def f(v, parts=tuple(parts)):
            return "".join(v if p is None else str(p) for p in parts)

        return f, key + ("@" + str(parts.index(None)),)
    if fn in ("json_extract", "json_extract_scalar"):
        path = e.args[1].value
        scalar = fn == "json_extract_scalar"

        def f(v, path=path, scalar=scalar):
            import json as _json

            got = _json_path_get(v, path)
            if got is None:
                return None
            if scalar:
                if isinstance(got, (dict, list)):
                    return None
                if isinstance(got, bool):
                    return "true" if got else "false"
                return str(got)
            return _json.dumps(got, separators=(",", ":"))

        return f, key
    if fn.startswith("url_extract_"):
        from urllib.parse import urlparse

        part = fn[len("url_extract_"):]

        def f(v, part=part):
            try:
                u = urlparse(v)
            except Exception:
                return None
            got = {"host": u.hostname, "path": u.path, "protocol": u.scheme,
                   "query": u.query}[part]
            return got if got else (got if part == "path" else None)

        return f, key
    return None

