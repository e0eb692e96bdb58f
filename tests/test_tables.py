"""Standard-table loader hardening + fingerprint registry (VERDICT r4
item 8): the published 38.212 / EN 302 307 tables arrive in messy
real-world formats; every accepted variant must parse to the SAME table
(same fingerprint), and registered fingerprints must make a silent table
change fail loudly — keeping the bit-true upgrade one verified data file
away (PROVENANCE.md)."""
import numpy as np
import pytest

from myldpccppapi.codes.nr import nr_base_graph, nr_code, parse_bg_table
from myldpccppapi.codes.dvbs2 import parse_address_table
from myldpccppapi.codes import tables


# ---------------------------------------------------------------------------
# parse_bg_table format variants
# ---------------------------------------------------------------------------

CANONICAL = """
# TS 38.212 Table 5.3.2-2 style: row col V(iLS=0..7)
0 0 1 2 3 4 5 6 7 8
0 1 10 11 12 13 14 15 16 17
1 1 0 0 0 0 0 0 0 0
"""

CSV_WITH_HEADER = """
Row,Col,V0,V1,V2,V3,V4,V5,V6,V7
0,0,1,2,3,4,5,6,7,8
0,1,10,11,12,13,14,15,16,17   % inline MATLAB-style comment
1,1,0,0,0,0,0,0,0,0
"""


def test_bg_table_csv_variant_fingerprints_identical():
    a = parse_bg_table(CANONICAL)
    b = parse_bg_table(CSV_WITH_HEADER)
    assert a.shape == (2, 2, 8)
    assert (a == b).all()
    assert tables.table_fingerprint(a) == tables.table_fingerprint(b)
    assert a[1, 0, 0] == -1  # null entry


def test_bg_table_per_set_and_dense_variants():
    # per-set sparse: "row col V" (one lifting set per file)
    per_set = """
    i j V   # header-ish comment line is fine too
    0 0 7
    0 1 16;  1 1 0
    """
    # NOTE: semicolons are separators, so the line above is NOT two
    # entries — it is one 6-token line.  Widths must be consistent:
    with pytest.raises(ValueError, match="inconsistent column counts"):
        parse_bg_table(per_set)
    per_set_ok = "0 0 7\n0 1 16\n1 1 0\n"
    t = parse_bg_table(per_set_ok)
    assert t.shape == (2, 2) and t[1, 0] == -1 and t[0, 1] == 16
    # dense matrix export (the common MATLAB/numpy form), -1 nulls
    dense = "7, 16\n-1, 0\n"
    d = parse_bg_table(dense)
    assert d.shape == (2, 2)
    assert (d == t).all()
    assert tables.table_fingerprint(d) == tables.table_fingerprint(t)


def test_bg_table_rejects_corruption():
    with pytest.raises(ValueError, match="duplicate"):
        parse_bg_table("0 0 1 2 3 4 5 6 7 8\n0 0 1 2 3 4 5 6 7 9")
    with pytest.raises(ValueError, match="non-integer"):
        parse_bg_table("0 0 1 2 3 4 5 6 7 8\n0 1 1 2 3 4 5 x 7 8")
    with pytest.raises(ValueError, match="no table entries"):
        parse_bg_table("# nothing\n% here\n")


def test_bg_table_2d_drop_in_builds_code():
    """A parsed single-set table feeds nr_code(table=) directly and must
    reproduce the same code as the in-memory array (round-trip through
    the dense text form)."""
    raw = nr_base_graph(2)
    text = "\n".join(" ".join(str(v) for v in row) for row in raw)
    parsed = parse_bg_table(text)
    assert (parsed == raw).all()
    a = nr_code(z=16, bg=2, table=parsed)
    b = nr_code(z=16, bg=2, table=raw)
    assert (a.base == b.base).all()


# ---------------------------------------------------------------------------
# parse_address_table format variants
# ---------------------------------------------------------------------------

def test_address_table_variants_fingerprint_identical():
    ws = "54 9318 14392\n27 4836\n"
    csv = """
    q = 25  addresses per bit group    # header line, skipped
    54, 9318, 14392
    27, 4836   % Annex B prints them comma-separated
    """
    a, b = parse_address_table(ws), parse_address_table(csv)
    assert a == b == ((54, 9318, 14392), (27, 4836))
    assert tables.table_fingerprint(a) == tables.table_fingerprint(b)


def test_address_table_rejects_garbage():
    with pytest.raises(ValueError, match="negative"):
        parse_address_table("54 -3 12\n")
    with pytest.raises(ValueError, match="no address-table rows"):
        parse_address_table("# only comments\n")


# ---------------------------------------------------------------------------
# fingerprint registry semantics
# ---------------------------------------------------------------------------

def test_registry_verify_and_tamper_detection():
    t = parse_bg_table(CANONICAL)
    name = "test_bg_mini"
    tables.register(name, tables.table_fingerprint(t))
    assert tables.verify(name, t) is True
    tampered = t.copy()
    tampered[0, 0, 0] += 1
    with pytest.raises(ValueError, match="mismatch"):
        tables.verify(name, tampered)
    # unregistered: False, or raise under strict
    assert tables.verify("test_unregistered", t) is False
    with pytest.raises(ValueError, match="no fingerprint registered"):
        tables.verify("test_unregistered", t, strict=True)
    # re-registering a different fingerprint is a provenance event
    with pytest.raises(ValueError, match="already registered"):
        tables.register(name, "0" * 64)
    tables.register(name, tables.table_fingerprint(t))  # same value ok


def test_shipped_default_fingerprints_pinned():
    """The SHIPPED defaults' fingerprints, pinned: a silent change to a
    default table (new seed, edited support, refactor that perturbs the
    draw) fails here instead of surfacing as a mysteriously shifted BER
    curve.  Intentional changes update these constants (a provenance
    event — note it in PROVENANCE.md)."""
    import warnings

    from myldpccppapi.codes.dvbs2 import synthetic_address_table
    from myldpccppapi.codes.dvbs2_designed import DESIGNED_ADDRESSES

    assert tables.table_fingerprint(nr_base_graph(1)) == (
        "033f5566f6e532c8528815db5e6c18707b3943f8f7ad895fb2229c8aec02c381")
    assert tables.table_fingerprint(nr_base_graph(2)) == (
        "302d0ab50b8b93aea878d83d3ff37e4737557a9b3c454e818783f8e19b647104")
    assert tables.table_fingerprint(
        DESIGNED_ADDRESSES[(16200, "1/2")]) == (
        "000653be1dc366d6469efa30339b9828818392997d5faa2241f5cd9587c05199")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        synth = synthetic_address_table(64800, "1/2")
    assert tables.table_fingerprint(synth) == (
        "f9ece725889943a770a1d0ff5803ade4fdb0eda99e755ceb6a0b9cf378ca97c0")


def test_bg_table_rejects_negative_indices_and_truncated_sparse():
    """Round-5 review findings: negative row/col would silently write the
    LAST row via Python indexing; a uniformly truncated sparse file (9
    tokens/line) must refuse rather than misparse as a dense matrix."""
    with pytest.raises(ValueError, match="negative"):
        parse_bg_table("0 0 7\n-1 1 3\n")
    with pytest.raises(ValueError, match="one off from the sparse"):
        parse_bg_table("0 0 1 2 3 4 5 6 7\n0 1 1 2 3 4 5 6 7\n")
    with pytest.raises(ValueError, match="< -1"):
        parse_bg_table("0 0 -2\n")


def test_nr_code_rejects_misshapen_2d_table():
    """A dense table missing a row/column must fail at construction, not
    as a shifted BER curve."""
    raw = nr_base_graph(2)
    with pytest.raises(ValueError, match="single-set table must be"):
        nr_code(z=16, bg=2, table=raw[:, :-1])
