"""Turner/Andronescu nearest-neighbor thermodynamic parameters.

Parses ViennaRNA 2.0 ``.par`` files into numpy arrays holding log-space
Boltzmann factors at 37C (value = -dG * 10 / kT, i.e. log of the Boltzmann
weight), matching the reference loader semantics
(/root/reference/RNAelem/energy_param.hpp:61-114,500-660):

* tables are stored with pair-type rows 1..6 (CG GC GU UG AU UA) or 1..7
  where the file provides an NN row; unread slots are log(0) = -inf,
* ``INF`` -> -inf, ``DEF`` -> energy of -50 (dacal/mol),
* mismatch_multi / mismatch_exterior / dangles go through the "smooth"
  soft-minimum transform (energy_param.hpp:95-106),
* NINIO is expanded to ``ninio[i] = B(min(max_ninio, i * f))`` for i<=30,
* tri/tetra/hexa special loops are kept as string->logB maps.

The default parameter sets are shipped pre-parsed as ``.npz`` (see
tools/convert_par.py); ``load_param_file`` handles user-provided ``.par``
files (plain text or C-string-literal quoted lines) for ``--energy-param``.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict

import numpy as np

GASCONST = 1.98717  # cal/K
K0 = 273.15
TEMPERATURE = 37
KT = (TEMPERATURE + K0) * GASCONST
MAXLOOP = 30
TURN = 3
NEG_INF = -np.inf
DEFAULT_LXC = 107.856

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

T2004 = "~T2004~"
A2007 = "~A2007~"


def _smooth(a: float) -> float:
    z = float(a)
    if z / 10.0 < -1.2283697:
        return 0.0
    if 0.8660254 < z / 10.0:
        return z
    s = 1.0 + math.sin(z / 10.0 - 0.34242663)
    return 10.0 * 0.38490018 * s * s


def _logb(z: float, smo: bool = False) -> float:
    """dacal/mol energy -> log Boltzmann weight."""
    if smo:
        return _smooth(-z) * 10.0 / KT
    return -z * 10.0 / KT


@dataclasses.dataclass
class EnergyParams:
    """Pytree-of-numpy-arrays holding log Boltzmann factors."""

    stack: np.ndarray          # [8,8]
    hairpin: np.ndarray        # [31]
    bulge: np.ndarray          # [31]
    internal: np.ndarray       # [31]
    mismatch_h: np.ndarray     # [8,5,5]
    mismatch_i: np.ndarray     # [8,5,5]
    mismatch_1n: np.ndarray    # [8,5,5]
    mismatch_23: np.ndarray    # [8,5,5]
    mismatch_m: np.ndarray     # [8,5,5]
    mismatch_e: np.ndarray     # [8,5,5]
    dangle5: np.ndarray        # [8,5]
    dangle3: np.ndarray        # [8,5]
    int11: np.ndarray          # [8,8,5,5]
    int21: np.ndarray          # [8,8,5,5,5]
    int22: np.ndarray          # [8,8,5,5,5,5]
    ninio: np.ndarray          # [31]
    term_au: float
    mlintern: float
    mlclosing: float
    ml_base: float
    lxc: float
    triloops: Dict[str, float]
    tetraloops: Dict[str, float]
    hexaloops: Dict[str, float]
    name: str = "~T2004~"

    def save_npz(self, path: str) -> None:
        meta = dict(self.__dict__)
        tri = meta.pop("triloops")
        tetra = meta.pop("tetraloops")
        hexa = meta.pop("hexaloops")
        np.savez_compressed(
            path,
            **{k: np.asarray(v) for k, v in meta.items() if k != "name"},
            name=np.asarray(self.name),
            tri_keys=np.asarray(list(tri.keys())),
            tri_vals=np.asarray(list(tri.values()), dtype=np.float64),
            tetra_keys=np.asarray(list(tetra.keys())),
            tetra_vals=np.asarray(list(tetra.values()), dtype=np.float64),
            hexa_keys=np.asarray(list(hexa.keys())),
            hexa_vals=np.asarray(list(hexa.values()), dtype=np.float64),
        )

    @staticmethod
    def load_npz(path: str) -> "EnergyParams":
        z = np.load(path, allow_pickle=False)
        def loops(pref):
            return {str(k): float(v)
                    for k, v in zip(z[pref + "_keys"], z[pref + "_vals"])}
        return EnergyParams(
            stack=z["stack"], hairpin=z["hairpin"], bulge=z["bulge"],
            internal=z["internal"], mismatch_h=z["mismatch_h"],
            mismatch_i=z["mismatch_i"], mismatch_1n=z["mismatch_1n"],
            mismatch_23=z["mismatch_23"], mismatch_m=z["mismatch_m"],
            mismatch_e=z["mismatch_e"], dangle5=z["dangle5"],
            dangle3=z["dangle3"], int11=z["int11"], int21=z["int21"],
            int22=z["int22"], ninio=z["ninio"],
            term_au=float(z["term_au"]), mlintern=float(z["mlintern"]),
            mlclosing=float(z["mlclosing"]), ml_base=float(z["ml_base"]),
            lxc=float(z["lxc"]), triloops=loops("tri"),
            tetraloops=loops("tetra"), hexaloops=loops("hexa"),
            name=str(z["name"]),
        )


class _Lines:
    """Line feeder that un-quotes C-string-literal style .par files."""

    def __init__(self, text: str):
        self.lines = [self._unquote(l) for l in text.splitlines()]
        self.pos = 0

    @staticmethod
    def _unquote(line: str) -> str:
        s = line.strip()
        if s.startswith('"'):
            s = s[1:]
            if s.endswith('\\n"'):
                s = s[:-3]
            elif s.endswith('"'):
                s = s[:-1]
            return s
        return line.rstrip("\n")

    def next(self):
        if self.pos >= len(self.lines):
            return None
        l = self.lines[self.pos]
        self.pos += 1
        return l

    def reset(self):
        self.pos = 0


def _get_array(feed: _Lines, size: int, smo: bool = False) -> np.ndarray:
    """Reference get_array (energy_param.hpp:159-183): read `size` numbers,
    stopping a line early at a '/*' token."""
    out = np.full(size, NEG_INF, dtype=np.float64)
    i = 0
    while i < size:
        line = feed.next()
        if line is None or len(line) < 2:
            break
        words = line.split()
        prev = i
        for w in words:
            if i >= size:
                break
            if "/*" in w:
                break
            if w == "INF":
                out[i] = NEG_INF
            elif w == "DEF":
                out[i] = _logb(-50, smo)
            else:
                out[i] = _logb(int(w), smo)
            i += 1
        if i == prev and line is not None and not words:
            break
    return out


def _read_block(feed, arr, dims, shifts, posts, smo=False):
    """Recursive read_Ndim (energy_param.hpp:184-379): iterate the leading
    dims over [shift, dim-post), read runs of the innermost dim."""
    if all(s == 0 for s in shifts) and all(p == 0 for p in posts):
        flat = _get_array(feed, int(np.prod(dims)), smo)
        arr.reshape(-1)[: flat.size] = flat
        return
    if len(dims) == 1:
        n = dims[0] - shifts[0] - posts[0]
        arr[shifts[0]: dims[0] - posts[0]] = _get_array(feed, n, smo)
        return
    for i in range(shifts[0], dims[0] - posts[0]):
        _read_block(feed, arr[i], dims[1:], shifts[1:], posts[1:], smo)


def _read_string_block(feed: _Lines) -> Dict[str, float]:
    out: Dict[str, float] = {}
    while True:
        line = feed.next()
        if line is None or line.strip() == "":
            break
        if "*" in line:
            continue
        words = line.split()
        if len(words) < 2:
            break
        out[words[0]] = _logb(int(words[1]))
    return out


def _read_values_line(feed: _Lines):
    while True:
        line = feed.next()
        if line is None or line.strip() == "":
            return None
        if "*" in line:
            continue
        return line.split()


def parse_par_text(text: str, name: str = "custom") -> EnergyParams:
    feed = _Lines(text)

    # first pass: lxc from Misc (read_only_misc, energy_param.hpp:504-519)
    lxc = DEFAULT_LXC
    while True:
        line = feed.next()
        if line is None:
            break
        if line.startswith("#") and len(line.split()) > 1 \
                and line.split()[1] == "Misc":
            while True:
                l2 = feed.next()
                if l2 is None or l2.strip() == "":
                    break
                if "*" in l2:
                    continue
                w = l2.split()
                if len(w) > 4:
                    lxc = float(w[4])
            break
    feed.reset()

    p = EnergyParams(
        stack=np.full((8, 8), NEG_INF), hairpin=np.full(31, NEG_INF),
        bulge=np.full(31, NEG_INF), internal=np.full(31, NEG_INF),
        mismatch_h=np.full((8, 5, 5), NEG_INF),
        mismatch_i=np.full((8, 5, 5), NEG_INF),
        mismatch_1n=np.full((8, 5, 5), NEG_INF),
        mismatch_23=np.full((8, 5, 5), NEG_INF),
        mismatch_m=np.full((8, 5, 5), NEG_INF),
        mismatch_e=np.full((8, 5, 5), NEG_INF),
        dangle5=np.full((8, 5), NEG_INF), dangle3=np.full((8, 5), NEG_INF),
        int11=np.full((8, 8, 5, 5), NEG_INF),
        int21=np.full((8, 8, 5, 5, 5), NEG_INF),
        int22=np.full((8, 8, 5, 5, 5, 5), NEG_INF),
        ninio=np.full(31, NEG_INF), term_au=0.0, mlintern=0.0,
        mlclosing=0.0, ml_base=0.0, lxc=lxc,
        triloops={}, tetraloops={}, hexaloops={}, name=name,
    )

    while True:
        line = feed.next()
        if line is None:
            break
        if not line.startswith("#"):
            continue
        words = line.split()
        if len(words) <= 1:
            continue
        sec = words[1]
        if sec == "stack":
            _read_block(feed, p.stack, (7, 7), (1, 1), (0, 0))
        elif sec == "mismatch_hairpin":
            _read_block(feed, p.mismatch_h, (7, 5, 5), (1, 0, 0), (0, 0, 0))
        elif sec == "mismatch_interior":
            _read_block(feed, p.mismatch_i, (7, 5, 5), (1, 0, 0), (0, 0, 0))
        elif sec == "mismatch_interior_1n":
            _read_block(feed, p.mismatch_1n, (7, 5, 5), (1, 0, 0), (0, 0, 0))
        elif sec == "mismatch_interior_23":
            _read_block(feed, p.mismatch_23, (7, 5, 5), (1, 0, 0), (0, 0, 0))
        elif sec == "mismatch_multi":
            _read_block(feed, p.mismatch_m, (8, 5, 5), (1, 0, 0), (0, 0, 0),
                        smo=True)
        elif sec == "mismatch_exterior":
            _read_block(feed, p.mismatch_e, (8, 5, 5), (1, 0, 0), (0, 0, 0),
                        smo=True)
        elif sec == "dangle5":
            _read_block(feed, p.dangle5, (8, 5), (1, 0), (0, 0), smo=True)
        elif sec == "dangle3":
            _read_block(feed, p.dangle3, (8, 5), (1, 0), (0, 0), smo=True)
        elif sec == "int11":
            _read_block(feed, p.int11, (8, 8, 5, 5), (1, 1, 0, 0),
                        (0, 0, 0, 0))
        elif sec == "int21":
            _read_block(feed, p.int21, (8, 8, 5, 5, 5), (1, 1, 0, 0, 0),
                        (0, 0, 0, 0, 0))
        elif sec == "int22":
            _read_block(feed, p.int22, (8, 8, 5, 5, 5, 5),
                        (1, 1, 1, 1, 1, 1), (1, 1, 0, 0, 0, 0))
        elif sec == "hairpin":
            p.hairpin[:] = _get_array(feed, 31)
        elif sec == "bulge":
            p.bulge[:] = _get_array(feed, 31)
        elif sec == "interior":
            p.internal[:] = _get_array(feed, 31)
        elif sec == "NINIO":
            w = _read_values_line(feed)
            if w:
                f, mx = int(w[0]), int(w[2])
                for i in range(MAXLOOP + 1):
                    p.ninio[i] = _logb(min(mx, i * f))
        elif sec == "ML_params":
            w = _read_values_line(feed)
            if w:
                p.ml_base = _logb(int(w[0]))
                p.mlclosing = _logb(int(w[2]))
                p.mlintern = _logb(int(w[4]))
        elif sec == "Misc":
            while True:
                l2 = feed.next()
                if l2 is None or l2.strip() == "":
                    break
                if "*" in l2:
                    continue
                w = l2.split()
                if len(w) > 2:
                    p.term_au = _logb(int(w[2]))
        elif sec == "Triloops":
            p.triloops = _read_string_block(feed)
        elif sec == "Tetraloops":
            p.tetraloops = _read_string_block(feed)
        elif sec == "Hexaloops":
            p.hexaloops = _read_string_block(feed)
    return p


def format_par_text(p: EnergyParams) -> str:
    """ViennaRNA 2.0 ``.par`` text that parse_par_text reads back into
    the same arrays: each log Boltzmann factor is written as the integer
    dacal/mol energy it came from (smoothed tables are inverted by
    search, since the soft-minimum transform maps every energy >= 13 to
    the same factor)."""
    smooth_inv = {}
    for z in range(5000, -5001, -1):
        smooth_inv[_logb(z, True)] = z

    def num(v, smo=False):
        if v == NEG_INF:
            return "INF"
        z = smooth_inv[v] if smo else int(round(-v * KT / 10.0))
        assert _logb(z, smo) == v, (v, z)
        return str(z)

    out = ["## RNAfold parameter file v2.0"]

    def block(name, rows, smo=False):
        out.append(f"\n# {name}")
        out.extend(" ".join(num(v, smo) for v in np.ravel(r)) for r in rows)

    rng = range(1, 7)
    block("stack", [p.stack[i, 1:7] for i in rng])
    for name, arr in (("mismatch_hairpin", p.mismatch_h),
                      ("mismatch_interior", p.mismatch_i),
                      ("mismatch_interior_1n", p.mismatch_1n),
                      ("mismatch_interior_23", p.mismatch_23)):
        block(name, [arr[i] for i in rng])
    for name, arr in (("mismatch_multi", p.mismatch_m),
                      ("mismatch_exterior", p.mismatch_e),
                      ("dangle5", p.dangle5), ("dangle3", p.dangle3)):
        block(name, [arr[i] for i in range(1, 8)], smo=True)
    pairs7 = [(i, j) for i in range(1, 8) for j in range(1, 8)]
    block("int11", [p.int11[i, j] for i, j in pairs7])
    block("int21", [p.int21[i, j] for i, j in pairs7])
    block("int22", [p.int22[i, j, k, l, m, 1:5]
                    for i in rng for j in rng for k in range(1, 5)
                    for l in range(1, 5) for m in range(1, 5)])
    for name, arr in (("hairpin", p.hairpin), ("bulge", p.bulge),
                      ("interior", p.internal)):
        block(name, [arr])
    e = [int(num(v)) for v in p.ninio]
    out.append(f"\n# NINIO\n{e[1]} 0 {max(e)}")
    out.append(f"\n# ML_params\n{num(p.ml_base)} 0 {num(p.mlclosing)} 0 "
               f"{num(p.mlintern)} 0")
    out.append(f"\n# Misc\n0 0 {num(p.term_au)} 0 {p.lxc!r}")
    for name, loops in (("Triloops", p.triloops),
                        ("Tetraloops", p.tetraloops),
                        ("Hexaloops", p.hexaloops)):
        out.append(f"\n# {name}")
        out.extend(f"{k} {num(v)}" for k, v in loops.items())
    return "\n".join(out) + "\n\n# END\n"


_CACHE: Dict[str, EnergyParams] = {}


def load(name_or_path: str) -> EnergyParams:
    """Load a default set (~T2004~ / ~A2007~) from shipped npz, or parse a
    user .par file."""
    if name_or_path in _CACHE:
        return _CACHE[name_or_path]
    if name_or_path == T2004:
        p = EnergyParams.load_npz(os.path.join(_DATA_DIR, "turner2004.npz"))
    elif name_or_path == A2007:
        p = EnergyParams.load_npz(os.path.join(_DATA_DIR,
                                               "andronescu2007.npz"))
    else:
        with open(name_or_path) as f:
            p = parse_par_text(f.read(), name=name_or_path)
        p.name = name_or_path
    if name_or_path in (T2004, A2007):
        p.name = name_or_path
    _CACHE[name_or_path] = p
    return p
