"""Parser parity vs golden dumps generated from the reference loader
(/root/reference/RNAelem/energy_param.hpp via tests/golden/tables_*.txt)."""
import os

import numpy as np
import pytest

from rnaelem_tpu.energy import params as P

GOLD = os.path.join(os.path.dirname(__file__), "golden")


def _load_gold(name):
    rows = []
    with open(os.path.join(GOLD, name)) as f:
        for line in f:
            rows.append(line.split())
    return rows


@pytest.mark.parametrize("which,gold", [
    (P.T2004, "tables_T2004.txt"),
    (P.A2007, "tables_A2007.txt"),
])
def test_tables_match_reference(which, gold):
    ep = P.load(which)
    rows = _load_gold(gold)
    tables = {
        "stack": ep.stack, "hairpin": ep.hairpin, "bulge": ep.bulge,
        "internal": ep.internal, "ninio": ep.ninio,
        "mish": ep.mismatch_h, "misi": ep.mismatch_i,
        "mis1n": ep.mismatch_1n, "mis23": ep.mismatch_23,
        "mism": ep.mismatch_m, "mise": ep.mismatch_e,
        "dan5": ep.dangle5, "dan3": ep.dangle3,
        "int11": ep.int11,
    }
    scalars = {
        "term_au": ep.term_au, "mlintern": ep.mlintern,
        "mlclosing": ep.mlclosing, "ml_base": ep.ml_base, "lxc": ep.lxc,
    }
    # Regions of the golden dump that captured the reference's
    # out-of-bounds memory (never read by any real lookup, where the pair
    # type is always <= 6): stack row 7 is adjacent `bulge` memory,
    # mismatch_1n row 0 holds mismatch_m's 8th-row overflow, and
    # mismatch_e row 7 of the dump aliased the triloop array.
    def _artifact(key, idx):
        return ((key == "stack" and int(idx[0]) == 7)
                or (key == "mis1n" and int(idx[0]) == 0)
                or (key == "mise" and int(idx[0]) == 7))

    n_checked = 0
    for row in rows:
        key = row[0]
        if key in tables:
            *idx, val = row[1:]
            if _artifact(key, idx):
                continue
            got = tables[key][tuple(int(i) for i in idx)]
            want = float(val)
            assert np.isclose(got, want, rtol=1e-12, atol=0) or (
                np.isinf(want) and np.isinf(got)), (key, idx, got, want)
            n_checked += 1
        elif key == "int21":
            t, u, a, b, val = row[1:]
            got = ep.int21[int(t), int(u), int(a), 1, int(b)]
            assert np.isclose(got, float(val), rtol=1e-12) or (
                np.isinf(float(val)) and np.isinf(got))
            n_checked += 1
        elif key == "int22":
            t, u, a, b, val = row[1:]
            got = ep.int22[int(t), int(u), int(a), 2, 3, int(b)]
            assert np.isclose(got, float(val), rtol=1e-12) or (
                np.isinf(float(val)) and np.isinf(got))
            n_checked += 1
        elif key in scalars:
            assert np.isclose(scalars[key], float(row[1]), rtol=1e-12)
            n_checked += 1
        elif key == "tristr":
            assert set(ep.triloops) == set(row[1:])
        elif key == "tetrastr":
            assert set(ep.tetraloops) == set(row[1:])
        elif key == "hexastr":
            assert set(ep.hexaloops) == set(row[1:])
        elif key in ("tri", "tetra", "hexa"):
            src = {"tri": ep.triloops, "tetra": ep.tetraloops,
                   "hexa": ep.hexaloops}[key]
            i, val = int(row[1]), float(row[2])
            vals = list(src.values())
            if i < len(vals):
                assert np.isclose(vals[i], val, rtol=1e-12), (key, i)
                n_checked += 1
    assert n_checked > 3000


@pytest.mark.parametrize("which", [P.T2004, P.A2007])
def test_par_roundtrip_text_equals_npz(which):
    # the shipped npz, written as reference-format .par text and parsed
    # back, must give the same arrays bit for bit
    p2 = P.load(which)
    p1 = P.parse_par_text(P.format_par_text(p2))
    for f in ("stack", "hairpin", "bulge", "internal", "mismatch_h",
              "mismatch_i", "mismatch_1n", "mismatch_23", "mismatch_m",
              "mismatch_e", "dangle5", "dangle3", "int11", "int21",
              "int22", "ninio"):
        np.testing.assert_array_equal(getattr(p1, f), getattr(p2, f),
                                      err_msg=f)
    for f in ("term_au", "mlintern", "mlclosing", "ml_base", "lxc",
              "triloops", "tetraloops", "hexaloops"):
        assert getattr(p1, f) == getattr(p2, f), f
