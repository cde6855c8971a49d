"""Timestamps and date arithmetic in the port: the reference's
``tests/test_timestamp.py`` statements over its six-row ``events``
table, built in both packages' ``MemoryConnector``, through both
``QueryRunner``s (the port on the CPU); K1's date and time opcodes
(TSPART, DTRUNC, DTADD, DTDIFF, CASTTS, UNIXT, DFMT, and comparisons of
a date with a timestamp) against the reference's ``ExprCompiler`` over
a seeded page of dates and timestamps across 1969, leap days, month
ends and week boundaries, with NULLs and dead rows; and the reference's
``date_diff`` month rule, pinned.

Tolerances: every lane is exact (valid masks everywhere, data where
valid; to_unixtime's doubles bit for bit: both divide by 1e6)."""

import datetime

import numpy as np
import pytest

from presto_tpu.expr import compile as ref_compile
from presto_tpu.expr import ir as ref_ir
from presto_tpu.types import parse_type as ref_type
from presto_tpu_torch.expr import compile as port_compile
from presto_tpu_torch.expr import ir as port_ir
from presto_tpu_torch.types import parse_type as port_type
from torch_fn_parity import C, F, L, build
from torch_parity import to_port

EPOCH = datetime.datetime(1970, 1, 1)
MICROS_PER_DAY = 86_400_000_000


def _ts(s: str) -> int:
    delta = datetime.datetime.fromisoformat(s) - EPOCH
    return (delta.days * 86_400 + delta.seconds) * 1_000_000 + delta.microseconds


def _days(s: str) -> int:
    return (datetime.date.fromisoformat(s) - EPOCH.date()).days


# tests/test_timestamp.py's events table
ROWS = [
    (1, "2021-01-31 10:30:15.250000", "2021-01-31", 10.0),
    (2, "2021-02-28 23:59:59", "2021-02-28", 20.0),
    (3, "2021-03-01 00:00:00", "2021-03-01", 30.0),
    (4, "2020-02-29 12:00:00", "2020-02-29", 40.0),
    (5, "1969-12-31 23:00:00", "1969-12-31", 50.0),
    (6, "2021-01-31 10:45:00", "2021-01-31", 60.0),
]

# every statement of tests/test_timestamp.py that reads the table or
# folds intervals (its niladic current_date test reads the clock)
TIMESTAMP_SQL = [
    "select id, created_at from events order by id",
    "select id from events where created_at > timestamp '2021-02-01 00:00:00' order by id",
    "select id from events where created_at >= date '2021-03-01'",
    "select id from events where cast(event_date as timestamp) = "
    "date_trunc('day', created_at) order by id",
    "select id, extract(year from created_at), extract(month from created_at),"
    " extract(day from created_at), extract(hour from created_at),"
    " extract(minute from created_at), extract(second from created_at)"
    " from events order by id",
    "select hour(created_at), minute(created_at), second(created_at),"
    " millisecond(created_at) from events where id = 1",
    "select date_trunc('hour', created_at), date_trunc('month', created_at),"
    " date_trunc('year', created_at), date_trunc('week', created_at)"
    " from events where id = 1",
    "select date_trunc('month', event_date), date_trunc('quarter', event_date)"
    " from events where id = 2",
    "select created_at + interval '90' minute from events where id = 2",
    "select created_at - interval '1' month from events where id = 3",
    "select created_at + interval '1' month from events where id = 1",
    "select timestamp '2021-01-31 10:00:00' + interval '2' hour",
    "select date '2021-01-31' + interval '1' month",
    "select event_date + interval '1' month from events where id = 4",
    "select event_date - interval '1' year from events where id = 1",
    "select date_add('hour', 3, created_at), date_add('month', 2, event_date)"
    " from events where id = 2",
    "select date_diff('day', date '2021-01-01', event_date),"
    " date_diff('hour', timestamp '2021-02-28 00:00:00', created_at)"
    " from events where id = 2",
    "select date_diff('month', date '2020-11-15', event_date) from events where id = 3",
    "select to_unixtime(created_at) from events where id = 3",
    "select from_unixtime(1614556800) ",
    "select cast(created_at as date) from events where id = 5",
    "select cast(event_date as timestamp) from events where id = 3",
    "select date_trunc('day', created_at) as d, count(*), sum(amount)"
    " from events group by date_trunc('day', created_at) order by d",
    "select min(created_at), max(created_at) from events",
]
# more of the same table: the slice's other paths over its columns
EXTRA_SQL = [
    "select id, date_format(created_at, '%Y-%m-%d'), date_format(event_date, '%m/%d/%Y')"
    " from events order by id",
    "select date_format(event_date, '%Y-%m') m, count(*), sum(amount) from events group by 1"
    " order by 1",
    "select id, date_diff('month', event_date, created_at), date_diff('year', created_at,"
    " date '2023-06-30'), date_diff('quarter', event_date, date '2019-01-01'),"
    " date_diff('week', created_at, timestamp '2021-03-15 00:00:00') from events order by id",
    "select id from events where event_date between date '2021-01-01' and created_at"
    " order by id",
    "select id, year(created_at), quarter(created_at), day_of_week(created_at),"
    " day_of_year(created_at), week(created_at) from events order by id",
    "select id, date_add('week', -1, event_date), date_add('quarter', 1, created_at),"
    " date_add('millisecond', 1500, created_at) from events order by id",
    "select id, to_unixtime(event_date), from_unixtime(amount * 1e8) from events order by id",
    "select id, coalesce(created_at, event_date), try(cast(created_at as date)) from events"
    " order by id",
]


@pytest.fixture(scope="module")
def runners():
    from presto_tpu.catalog import Catalog
    from presto_tpu.connectors.memory import MemoryConnector
    from presto_tpu.page import Page
    from presto_tpu.runner import QueryRunner
    from presto_tpu.types import BIGINT, DATE, DOUBLE, TIMESTAMP
    from presto_tpu_torch import types as pt
    from presto_tpu_torch.catalog import Catalog as PortCatalog
    from presto_tpu_torch.connectors.memory import MemoryConnector as PortMemory
    from presto_tpu_torch.page import Page as PortPage
    from presto_tpu_torch.runner import QueryRunner as PortRunner

    cols = [np.array([r[0] for r in ROWS], dtype=np.int64),
            np.array([_ts(r[1]) for r in ROWS], dtype=np.int64),
            np.array([_days(r[2]) for r in ROWS], dtype=np.int32),
            np.array([r[3] for r in ROWS], dtype=np.float64)]
    names = ["id", "created_at", "event_date", "amount"]
    mem = MemoryConnector()
    schema = list(zip(names, [BIGINT, TIMESTAMP, DATE, DOUBLE]))
    mem.create_table("events", schema, [Page.from_arrays(cols, [t for _, t in schema])])
    catalog = Catalog()
    catalog.register("mem", mem)
    port_mem = PortMemory(device="cpu")
    port_schema = list(zip(names, [pt.BIGINT, pt.TIMESTAMP, pt.DATE, pt.DOUBLE]))
    port_mem.create_table("events", port_schema,
                          [PortPage.from_arrays(cols, [t for _, t in port_schema])])
    port_catalog = PortCatalog()
    port_catalog.register("mem", port_mem)
    return QueryRunner(catalog), PortRunner(port_catalog, device="cpu")


@pytest.mark.parametrize("sql", TIMESTAMP_SQL + EXTRA_SQL)
def test_events_statement_equals_reference(runners, sql):
    ref, port = runners
    want = ref.execute(sql)
    got = port.execute(sql)
    assert [str(t) for t in got.types] == [str(t) for t in want.types]
    assert got.rows == want.rows


def test_timestamp_suite_assertions_hold(runners):
    """A few of tests/test_timestamp.py's own expectations, through the
    port: floor division before 1970, month-end clamping, Monday weeks."""
    _, port = runners
    dt = datetime.datetime.fromisoformat
    assert port.execute("select cast(created_at as date) from events where id = 5"
                        ).rows == [(_days("1969-12-31"),)]
    assert port.execute("select created_at + interval '1' month from events where id = 1"
                        ).rows == [(dt("2021-02-28 10:30:15.250000"),)]
    assert port.execute("select date_trunc('week', created_at) from events where id = 1"
                        ).rows == [(dt("2021-01-25"),)]
    assert port.execute("select event_date + interval '1' month from events where id = 4"
                        ).rows == [(_days("2020-03-29"),)]


# -- K1's date and time opcodes against the reference's ExprCompiler ----------

PAGE_COLUMNS = [("ts", "timestamp"), ("dt", "date"), ("n", "bigint"), ("u", "double"),
                ("dt2", "date")]
TS, DT, N, U, DT2 = C("ts"), C("dt"), C("n"), C("u"), C("dt2")

# days that bend the calendar: 1969's last days, leap days, month and
# year ends, a Sunday/Monday pair, 1900 and 2100 (no leap day)
EDGE_DAYS = ["1969-12-31", "1969-12-28", "1970-01-01", "1968-02-29", "2000-02-29",
             "2020-02-29", "2021-02-28", "2021-01-31", "2021-12-31", "1900-02-28",
             "2100-02-28", "2021-01-24", "2021-01-25", "1899-12-31", "2100-12-31"]


def _datetime_page(seed: int, n: int = 2048):
    """A reference page of ``PAGE_COLUMNS``: timestamps with a time of
    day and dates across 1880..2120 and the edge days, signed counts of
    units, epoch seconds as doubles, with NULLs and dead rows."""
    import jax.numpy as jnp

    from presto_tpu.page import Block, Page
    from torch_parity import with_nulls_and_dead_rows

    rng = np.random.default_rng(seed)
    days = rng.integers(-32000, 55000, n)
    pick = rng.random(n) < 0.3
    days[pick] = rng.choice([_days(d) for d in EDGE_DAYS], pick.sum())
    tod = rng.integers(0, MICROS_PER_DAY, n)
    tod[rng.random(n) < 0.2] = 0
    counts = rng.integers(-40, 40, n)
    counts[rng.random(n) < 0.05] = rng.choice([1200, -1200, 0], 1)[0]
    data = {"ts": days * MICROS_PER_DAY + tod, "dt": days.astype(np.int32),
            "n": counts, "u": rng.uniform(-4e9, 4e9, n).round(3),
            "dt2": rng.permutation(days).astype(np.int32)}
    blocks = [Block(jnp.asarray(data[c]), jnp.ones(n, jnp.bool_), ref_type(t), None)
              for c, t in PAGE_COLUMNS]
    return with_nulls_and_dead_rows(Page(tuple(blocks), jnp.ones(n, jnp.bool_)), rng)


def _unit(u):
    return L(u, "varchar")


SPECS = {}
for part in ("year", "month", "day", "quarter", "day_of_week", "day_of_year", "week",
             "year_of_week", "last_day_of_month", "hour", "minute", "second", "millisecond"):
    t = "date" if part == "last_day_of_month" else "bigint"
    SPECS[f"tspart_{part}"] = F(part, t, TS)
for part in ("hour", "minute", "second", "millisecond"):  # 0 over a date
    SPECS[f"datepart_{part}_of_date"] = F(part, "bigint", DT)
for u in ("second", "minute", "hour", "day", "week", "month", "quarter", "year"):
    SPECS[f"dtrunc_ts_{u}"] = F("date_trunc", "timestamp", _unit(u), TS)
for u in ("day", "week", "month", "quarter", "year"):
    SPECS[f"dtrunc_date_{u}"] = F("date_trunc", "date", _unit(u), DT)
for u in ("millisecond", "second", "minute", "hour", "day", "week", "month", "quarter", "year"):
    SPECS[f"dtadd_ts_{u}"] = F("date_add", "timestamp", _unit(u), N, TS)
for u in ("day", "week", "month", "quarter", "year"):
    SPECS[f"dtadd_date_{u}"] = F("date_add", "date", _unit(u), N, DT)
for u in ("millisecond", "second", "minute", "hour", "day", "week", "month", "quarter", "year"):
    SPECS[f"dtdiff_ts_{u}"] = F("date_diff", "bigint", _unit(u), TS,
                                F("ts_add_micros", "timestamp", TS,
                                  F("mul", "bigint", N, L(987_654_321_012, "bigint"))))
for u in ("day", "week", "month", "quarter", "year"):
    SPECS[f"dtdiff_date_{u}"] = F("date_diff", "bigint", _unit(u), DT, DT2)
SPECS.update({
    "dtdiff_mixed_month": F("date_diff", "bigint", _unit("month"), DT, TS),
    "dtdiff_mixed_hour": F("date_diff", "bigint", _unit("hour"), TS, DT2),
    "ts_add_micros": F("ts_add_micros", "timestamp", TS, F("mul", "bigint", N,
                                                           L(3_600_000_001, "bigint"))),
    "ts_add_months": F("ts_add_months", "timestamp", TS, N),
    "date_add_months": F("date_add_months", "date", DT, N),
    "date_add_days": F("date_add_days", "date", DT, N),
    "cast_timestamp": F("cast_timestamp", "timestamp", DT),
    "cast_date": F("cast_date", "date", TS),
    "to_unixtime_ts": F("to_unixtime", "double", TS),
    "to_unixtime_date": F("to_unixtime", "double", DT),
    "from_unixtime": F("from_unixtime", "timestamp", U),
    "date_format_date": F("date_format", "varchar", DT, L("%Y-%m-%d", "varchar")),
    "date_format_ts": F("date_format", "varchar", TS, L("%Y-%m", "varchar")),
    "cmp_ts_date": F("lt", "boolean", TS, DT2),
    "cmp_date_ts": F("eq", "boolean", DT, F("date_trunc", "timestamp", _unit("day"), TS)),
    "between_mixed": F("between", "boolean", TS, DT, DT2),
    "coalesce_mixed": F("coalesce", "timestamp", TS, DT),
    "trunc_of_add": F("date_trunc", "timestamp", _unit("month"),
                      F("ts_add_months", "timestamp", TS, L(-13, "bigint"))),
})


@pytest.mark.parametrize("name", sorted(SPECS))
def test_datetime_opcode_equals_reference(name):
    """The port's K1 twin against the reference's ExprCompiler, exact."""
    spec = SPECS[name]
    ref_page = _datetime_page(sum(map(ord, name)))
    port_page = to_port(ref_page)
    ref_e = build(spec, ref_ir, ref_type, PAGE_COLUMNS)
    port_e = build(spec, port_ir, port_type, PAGE_COLUMNS)
    rd, rv = ref_compile.ExprCompiler.for_page(ref_page).compile(ref_e)(ref_page)
    pd, pv = port_compile.ExprCompiler.for_page(port_page).compile(port_e)(port_page)
    live = np.asarray(ref_page.row_mask)
    rd, rv, pd, pv = np.asarray(rd), np.asarray(rv), pd.numpy(), pv.numpy()
    np.testing.assert_array_equal(pv[live], rv[live], err_msg=f"{name} valid")
    ok = live & rv
    if pd.dtype == np.float64:
        np.testing.assert_array_equal(pd[ok].view(np.int64), rd[ok].view(np.int64), name)
    else:
        np.testing.assert_array_equal(pd[ok], rd[ok].astype(pd.dtype), err_msg=name)


@pytest.mark.parametrize("a,b,want", [
    ("2021-01-31", "2021-02-01", 1),  # Presto's whole elapsed months: 0
    ("2021-01-01", "2021-01-31", 0),
    ("2020-02-29", "2021-02-28", 12),  # Presto: 11
    ("2021-03-31", "2021-02-28", -1),  # Presto: 0
])
def test_date_diff_month_counts_calendar_fields(runners, a, b, want):
    """date_diff('month' | 'quarter' | 'year') counts calendar-field
    differences, (y2 * 12 + m2) - (y1 * 12 + m1), as the reference's
    _compile_datetime documents, where Presto counts whole elapsed
    periods (ROADMAP C): the port follows the reference."""
    ref, port = runners
    sql = f"select date_diff('month', date '{a}', date '{b}')"
    assert port.execute(sql).rows == ref.execute(sql).rows == [(want,)]


@pytest.mark.parametrize("sql", [
    "select date_trunc('millisecond', created_at) from events",
    "select date_add('hour', 1, event_date) from events",
])
def test_units_outside_the_reference_raise_by_name(runners, sql):
    """Units the reference has no branch for raise NotPorted by name."""
    from presto_tpu_torch import NotPorted

    with pytest.raises(NotPorted) as e:
        runners[1].execute(sql)
    assert e.value.what.startswith(("date_trunc unit", "date_add unit"))
