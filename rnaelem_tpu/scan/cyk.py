"""Viterbi/CYK alignment of structure + motif states, with traceback.

The max-semiring twin of the inside DP (CYKFun, motif_scanner.hpp:802-913)
runs on device via ops/dp.py with semiring="max" and the start/end pins
(Ys, Ye) expressed as -inf aux vetoes; the traceback
(motif_scanner.hpp:262-362) runs on host, re-deriving each cell's argmax
from the returned tables — no trace tensors need to be stored on device.

Tie-breaking: the reference keeps the first strictly-greater candidate in
its sequential evaluation order; we enumerate candidates in the same
order (P_E before P_P, split points in loop order, O_O last) so
tracebacks agree except for exactly-equal-score alternatives that differ
only in motif-state enumeration order.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..model import joint as J
from ..ops import dp_max as DP

NEG = -np.inf
# energy-state ids for the host traceback stack
LLs, Ps, Es, Ms, Bs, S1s, S2s, Os = range(8)


@functools.lru_cache(maxsize=32)
def _cyk_kernel(cfg: J.ModelConfig):
    k = J.kernels(cfg)
    _, tables = DP.build_dp(k.g, k.dims_max, k.tab,
                            jnp.dtype(cfg.dtype), semiring="max")
    return jax.jit(tables)


def _pin_aux(cfg, g, m, Ys, Ye, L, dtype):
    """CYKFun's Ys/Ye vetoes as aux tensors (motif_scanner.hpp:839-873)."""
    Lp, S = cfg.Lp, g.S
    pos = jnp.arange(Lp)[:, None, None]

    def pin(allow_start, allow_end, tail=None):
        a = jnp.zeros((Lp, S, S), dtype)
        a = jnp.where(pos == Ys,
                      jnp.where(allow_start[None], 0.0, NEG), a)
        a = a + jnp.where(pos == Ye,
                          jnp.where(allow_end[None], 0.0, NEG), 0.0)
        if tail is not None:
            # (j == ye and L == j): only target.r == M-2 survives at the
            # final emitted base
            cond = (pos == L - 1) & (Ye == L)
            a = a + jnp.where(cond, jnp.where(tail[None], 0.0, NEG), 0.0)
        return a

    return dict(
        auxR=pin(m.r_start, m.r_end, m.r_tail),
        auxL=pin(m.l_start, m.l_end),
        auxPL=pin(m.pl_start, m.pl_end),
        auxPR=pin(m.pr_start, m.pr_end, m.pr_tail),
    )


def cyk_tables(cfg: J.ModelConfig, params: J.Params, sd: J.SeqData,
               Ys, Ye):
    from .scanner import state_masks
    J.kernels(cfg)
    state_masks(cfg)
    _cyk_kernel(cfg)
    return _cyk_tables_jit(cfg, params, sd, Ys, Ye)


@functools.partial(jax.jit, static_argnums=(0,))
def _cyk_tables_jit(cfg: J.ModelConfig, params: J.Params, sd: J.SeqData,
                    Ys, Ye):
    from .scanner import state_masks
    assert cfg.with_aux
    k = J.kernels(cfg)
    m = state_masks(cfg)
    dtype = jnp.dtype(cfg.dtype)
    bp_ok, _ = J._effective_bp_mask_jit(cfg, sd)
    aux = _pin_aux(cfg, k.g, m, Ys, Ye, sd.L, dtype)
    d, c = J.factors(cfg, params, sd, bp_ok, aux)
    tabs = _cyk_kernel(cfg)(d, c)
    return tabs, d, c


def _il_np(tab, seq, j, Wp, Cp, C, no_ene, dots_cum=None):
    """Pure-numpy twin of energy.tables.iloop_scores for the host
    traceback: the jnp version dispatches dozens of device ops per
    visited E-cell.  Same math, host arrays."""
    w = np.arange(Wp + 1)[:, None, None]
    dk = np.arange(Cp + 1)[None, :, None]
    dl = np.arange(Cp + 1)[None, None, :]
    i = j - w
    k = i + dk
    l = j - dl
    u1, u2 = dk, dl
    usum = u1 + u2
    umax = np.maximum(u1, u2)
    sg = lambda a, idx: a[np.clip(idx, 0, a.shape[0] - 1)]

    valid = (usum >= 1) & (usum <= C) & (w - dk - dl >= 0) & (i >= 0)
    if dots_cum is not None:
        valid = valid & ((sg(dots_cum, k) - sg(dots_cum, i)) == dk) \
            & ((sg(dots_cum, j * np.ones_like(l)) - sg(dots_cum, l))
               == dl)
    if no_ene:
        return np.where(valid, 0.0, NEG)

    MAXLOOP = 30
    t = tab["bp"][sg(seq, i - 1), sg(seq, j + 0 * w)]
    t2 = tab["bp"][sg(seq, l - 1), sg(seq, k)]
    b_i = sg(seq, i)
    b_jm = sg(seq, (j - 1) + 0 * w)
    b_l = sg(seq, l)
    b_km = sg(seq, k - 1)

    uc = np.clip(umax, 0, MAXLOOP)
    usc = np.clip(usum, 0, MAXLOOP)
    au = np.where(t > 2, tab["term_au"], 0.0)
    au2 = np.where(t2 > 2, tab["term_au"], 0.0)
    bulge = np.where(umax == 1, tab["bulge"][uc] + tab["stack"][t, t2],
                     tab["bulge"][uc] + au + au2)
    int11 = tab["int11"][t, t2, b_i, b_jm]
    int21a = tab["int21"][t, t2, b_i, b_l, b_jm]
    int21b = tab["int21"][t2, t, b_l, b_i, b_km]
    int22 = tab["int22"][t, t2, b_i, b_km, b_l, b_jm]
    short = np.where(
        usum == 2, int11,
        np.where((u1 == 1) & (u2 == 2), int21a,
                 np.where((u1 == 2) & (u2 == 1), int21b, int22)))
    mis_long = np.where(
        (u1 == 1) | (u2 == 1),
        tab["mismatch_1n"][t, b_i, b_jm]
        + tab["mismatch_1n"][t2, b_l, b_km],
        np.where(
            usum == 5,
            tab["mismatch_23"][t, b_i, b_jm]
            + tab["mismatch_23"][t2, b_l, b_km],
            tab["mismatch_i"][t, b_i, b_jm]
            + tab["mismatch_i"][t2, b_l, b_km]))
    longi = tab["internal"][usc] \
        + tab["ninio"][np.clip(np.abs(u1 - u2), 0, MAXLOOP)] + mis_long
    z = np.where((u1 == 0) | (u2 == 0), bulge,
                 np.where(umax <= 2, short, longi))
    z = np.where(usum > MAXLOOP, NEG, z)
    return np.where(valid, z, NEG)


@functools.lru_cache(maxsize=8)
def _tab_np(cfg: J.ModelConfig):
    k = J.kernels(cfg)
    return {key: np.asarray(v) for key, v in k.tab.items()
            if key in ("bp", "term_au", "bulge", "stack", "int11",
                       "int21", "int22", "mismatch_1n", "mismatch_23",
                       "mismatch_i", "internal", "ninio")}


@dataclasses.dataclass
class _Host:
    """Host-side candidate scorer over numpy-fied tables/factors."""
    cfg: J.ModelConfig
    g: object
    tabs: tuple
    d: object
    c: object
    il_cache: dict

    def __post_init__(self):
        n = lambda x: np.asarray(x)
        (self.LL, self.P, self.E, self.M, self.B,
         self.T1, self.T2, self.O) = [n(t) for t in self.tabs]
        self.eR = n(self.d.eR)
        self.eL = n(self.d.eL)
        self.bg2 = n(self.d.bg2)
        self.pv = n(self.d.pv)
        self.lam = n(self.d.lam)
        self.auxR = n(self.d.auxR)
        self.auxL = n(self.d.auxL)
        self.auxPL = n(self.d.auxPL)
        self.auxPR = n(self.d.auxPR)
        self.wsp = n(self.c.wsp)
        self.TR = n(self.c.TR)
        self.TL = n(self.c.TL)
        self.TPm = n(self.c.TPm)
        for f in ("hp", "stk", "ext", "ml2", "mlE"):
            setattr(self, f, n(getattr(self.c, f)))
        self.gate = n(self.c.gate_O2)
        self.C = int(self.c.C)
        self.L = int(self.c.L)
        g = self.g
        self.lamv = self.lam[g.lam_bucket]
        self.ptab = np.maximum(g.pair_table_index[g.pt_tab], 0)

    def lam_mul(self, s, tsc):
        return NEG if tsc == NEG else self.lamv[s] * tsc

    def table(self, e):
        return (self.LL, self.P, self.E, self.M, self.B,
                self.T1, self.T2)[e]

    def pem(self, i, j, s, s1):
        """Pair emission for target s at (i,j), source s1."""
        g = self.g
        if not g.pt[s, s1]:
            return NEG
        if g.pt_isbp[s, s1]:
            v = self.pv[j, j - i, self.ptab[s, s1]]
            if g.pt_wl[s, s1]:
                v += self.wsp[i]
            if g.pt_wr[s, s1]:
                v += self.wsp[j - 1]
        else:
            v = self.bg2[i] + self.bg2[j - 1]
        v += self.TPm[s, s1] if g.pt_tau[s, s1] else 0.0
        v += self.auxPL[i, s, s1] + self.auxPR[j - 1, s, s1]
        return v

    def il(self, j):
        if j not in self.il_cache:
            self.il_cache[j] = _il_np(
                _tab_np(self.cfg), np.asarray(self.c.seq), j,
                self.cfg.Wp, self.cfg.Cp, self.C, self.cfg.no_ene,
                np.asarray(self.c.dots_cum) if self.cfg.fix_rss
                else None)
        return self.il_cache[j]


def _candidates(h: _Host, e: int, i: int, j: int, s: int):
    """Candidate (score, action) list for one cell, in the reference's
    evaluation order.  Actions are (tt, payload) consumed by traceback."""
    g = h.g
    S = g.S
    w = j - i
    out: List[Tuple[float, tuple]] = []

    if e == Os:
        # TT_O_OP for split i' descending, then TT_O_O
        for isp in range(j - 1, max(-1, j - h.cfg.Wp + 0) - 1, -1):
            wp = j - isp
            if wp > h.cfg.Wp:
                continue
            for (ts, s1, s2) in g.op_tuples:
                if ts != s:
                    continue
                sc = (h.O[isp, s2] + h.P[j, wp, s1]
                      + h.lam_mul(s, h.ext[j, wp]))
                out.append((sc, ("O_OP", isp, s1, s2)))
        if j > 0:
            for s1 in range(S):
                if not g.rt[s, s1]:
                    continue
                sc = (h.O[j - 1, s1] + h.TR[s, s1] + h.eR[j - 1, s]
                      + h.gate[j - 1] + h.auxR[j - 1, s, s1])
                out.append((sc, ("O_O", s1)))
        return out

    if e == LLs:
        for s1 in range(S):
            if not g.rt[s, s1]:
                continue
            sc = (h.LL[j - 1, w - 1, s1] + h.TR[s, s1]
                  + h.eR[j - 1, s] + h.auxR[j - 1, s, s1])
            out.append((sc, ("L_L", s1)))
        return out

    if e == Ps:
        for s1 in range(S):
            pe = h.pem(i, j, s, s1)
            if pe == NEG:
                continue
            sc = h.E[j - 1, w - 2, s1] + pe
            out.append((sc, ("P_E", s1)))
            sc = (h.P[j - 1, w - 2, s1] + pe
                  + h.lam_mul(s, h.stk[j, w]))
            out.append((sc, ("P_P", s1)))
        return out

    if e == S2s:
        for s1 in range(S):
            if not g.rt[s, s1]:
                continue
            sc = (h.T2[j - 1, w - 1, s1] + h.TR[s, s1]
                  + h.eR[j - 1, s] + h.gate[j - 1]
                  + h.auxR[j - 1, s, s1])
            out.append((sc, ("2_2", s1)))
        out.append((h.P[j, w, s] + h.lam_mul(s, h.ml2[j, w]),
                    ("2_P",)))
        return out

    if e == S1s:
        out.append((h.T2[j, w, s], ("1_2",)))
        out.append((h.B[j, w, s], ("1_B",)))
        return out

    if e == Bs:
        for k in range(i + 1, j):
            for (ts, s1, s2) in g.b12_tuples:
                if ts != s:
                    continue
                sc = h.T1[k, k - i, s1] + h.T2[j, j - k, s2]
                out.append((sc, ("B_12", k, s1, s2)))
        return out

    if e == Ms:
        for s1 in range(S):
            if not g.lt[s, s1]:
                continue
            sc = (h.M[j, w - 1, s1] + h.TL[s, s1] + h.eL[i, s1]
                  + h.gate[i] + h.auxL[i, s, s1])
            out.append((sc, ("M_M", s1)))
        out.append((h.B[j, w, s], ("M_B",)))
        return out

    if e == Es:
        if g.loop_mask[s]:
            out.append((h.LL[j, w, s] + h.lam_mul(s, h.hp[j, w]),
                        ("E_H",)))
        out.append((h.M[j, w, s] + h.lam_mul(s, h.mlE[j, w]),
                    ("E_M",)))
        # TT_E_P: vectorized over (dl, dk, quadruple) in the reference's
        # evaluation order (motif_scanner.hpp:875-905), argmax picks the
        # first maximal candidate like the sequential loop did
        tup = g.ep_tuples[g.ep_tuples[:, 0] == s]
        nd = min(h.cfg.Cp, w)
        if len(tup) and nd >= 0:
            il = h.il(j)
            dls = np.arange(nd + 1)
            DL, DK = np.meshgrid(dls, dls, indexing="ij")
            valid = (DK <= np.minimum(h.cfg.Cp, w - DL)) \
                & ~((DK == 0) & (DL == 0)) & (DL + DK <= w)
            tsc = il[w, DK, DL]
            valid &= tsc != NEG
            if valid.any():
                ll = j - DL
                kk = i + DK
                vv = np.clip(ll - kk, 0, None)
                s1, s2, s3 = tup[:, 1], tup[:, 2], tup[:, 3]
                # mask -inf BEFORE the lambda multiply: -inf * 0 would
                # make NaNs (and RuntimeWarning spam) that the where
                # only hides after the fact
                tfin = np.where(tsc == NEG, 0.0, tsc)
                sc = (h.P[ll[:, :, None], vv[:, :, None],
                          s1[None, None, :]]
                      + h.LL[kk[:, :, None], DK[:, :, None],
                             s2[None, None, :]]
                      + h.LL[j, DL[:, :, None], s3[None, None, :]]
                      + np.where(tsc == NEG, NEG,
                                 h.lamv[s] * tfin)[:, :, None])
                sc = np.where(valid[:, :, None], sc, NEG)
                flat = np.argmax(sc)
                di, ki, qi = np.unravel_index(flat, sc.shape)
                out.append((float(sc[di, ki, qi]),
                            ("E_P", i + int(DK[di, ki]),
                             j - int(DL[di, ki]), int(s1[qi]),
                             int(s2[qi]), int(s3[qi]))))
        return out

    raise AssertionError(e)


def traceback(cfg: J.ModelConfig, tabs, d, c) -> Tuple[np.ndarray, str]:
    """Returns (cyk_state_path [L], cyk_structure_path string)."""
    g = J.kernels(cfg).g
    h = _Host(cfg, g, tuple(tabs), d, c, {})
    L = h.L
    state_path = np.zeros(L, np.int64)
    struct = [" "] * L
    n2s = g.n2s

    # end state choice (motif_scanner.hpp:176-183)
    sA, sB = int(g.end_states[1]), int(g.end_states[2])
    s0 = sB if h.O[L, sA] < h.O[L, sB] else sA

    stack = [(0, L, Os, s0)]
    guard = 0
    while stack:
        guard += 1
        if guard > 40 * (L + 2):
            raise RuntimeError("cyk traceback did not terminate")
        i, j, e, s = stack.pop()
        if e == LLs and j <= i:
            continue
        if e == Os and j <= 0:
            continue
        cands = _candidates(h, e, i, j, s)
        if not cands:
            continue
        scores = np.array([sc for sc, _ in cands])
        act = cands[int(np.argmax(scores))][1]
        tt = act[0]
        sl, sr = g.state_l, g.state_r

        if tt == "L_L":
            state_path[j - 1] = sr[s]
            stack.append((i, j - 1, LLs, act[1]))
        elif tt == "O_O":
            state_path[j - 1] = sr[s]
            struct[j - 1] = "O"
            stack.append((0, j - 1, Os, act[1]))
        elif tt == "2_2":
            state_path[j - 1] = sr[s]
            struct[j - 1] = "M"
            stack.append((i, j - 1, S2s, act[1]))
        elif tt == "E_H":
            for p in range(i, j):
                struct[p] = "H"
            stack.append((i, j, LLs, s))
        elif tt == "E_M":
            stack.append((i, j, Ms, s))
        elif tt == "M_B":
            stack.append((i, j, Bs, s))
        elif tt == "2_P":
            stack.append((i, j, Ps, s))
        elif tt == "1_2":
            stack.append((i, j, S2s, s))
        elif tt == "1_B":
            stack.append((i, j, Bs, s))
        elif tt in ("P_E", "P_P"):
            s1 = act[1]
            state_path[i] = sl[s1]
            struct[i] = "L"
            state_path[j - 1] = sr[s]
            struct[j - 1] = "R"
            stack.append((i + 1, j - 1, Es if tt == "P_E" else Ps, s1))
        elif tt == "O_OP":
            _, isp, s1, s2 = act
            stack.append((isp, j, Ps, s1))
            stack.append((0, isp, Os, s2))
        elif tt == "E_P":
            _, k, l, s1, s2, s3 = act
            if l == j:
                for p in range(i, k):
                    struct[p] = "B"
            elif k == i:
                for p in range(l, j):
                    struct[p] = "B"
            else:
                for p in range(i, k):
                    struct[p] = "I"
                for p in range(l, j):
                    struct[p] = "I"
            stack.append((l, j, LLs, s3))
            stack.append((i, k, LLs, s2))
            stack.append((k, l, Ps, s1))
        elif tt == "B_12":
            _, k, s1, s2 = act
            stack.append((k, j, S2s, s2))
            stack.append((i, k, S1s, s1))
        elif tt == "M_M":
            s1 = act[1]
            state_path[i] = sl[s1]
            struct[i] = "M"
            stack.append((i + 1, j, Ms, s1))
        else:
            raise AssertionError(tt)
    return state_path, "".join(struct)


def viterbi_alignment(cfg: J.ModelConfig, params: J.Params, sd: J.SeqData,
                      Ys: int, Ye: int):
    tabs, d, c = cyk_tables(cfg, params, sd, jnp.asarray(Ys),
                            jnp.asarray(Ye))
    return traceback(cfg, tabs, d, c)


@functools.partial(jax.jit, static_argnums=(0,))
def _cyk_tables_batch_jit(cfg: J.ModelConfig, params: J.Params, sd_b,
                          Ys_b, Ye_b):
    """vmapped CYK tables: one device program per chunk instead of one
    dispatch per read."""
    from .scanner import state_masks
    assert cfg.with_aux
    k = J.kernels(cfg)
    m = state_masks(cfg)
    dtype = jnp.dtype(cfg.dtype)
    bp_ok_b, _ = J._effective_bp_mask_batch_jit(cfg, sd_b)
    kern = _cyk_kernel(cfg)

    def one(sd, Ys, Ye, bp_ok):
        aux = _pin_aux(cfg, k.g, m, Ys, Ye, sd.L, dtype)
        d, c = J.factors(cfg, params, sd, bp_ok, aux)
        return kern(d, c), d, c

    return jax.vmap(one)(sd_b, Ys_b, Ye_b, bp_ok_b)


def _pin_aux_np(cfg, g, m, Ys, Ye, L):
    """Numpy twin of _pin_aux for the host traceback (the pin tensors
    are pure 0/-inf patterns of (Ys, Ye, L) — rebuilding them beats
    fetching ~1.3 MB/read of masks from the device)."""
    Lp, S = cfg.Lp, g.S
    pos = np.arange(Lp)[:, None, None]

    def pin(allow_start, allow_end, tail=None):
        a = np.zeros((Lp, S, S))
        a = np.where(pos == Ys,
                     np.where(np.asarray(allow_start)[None], 0.0, NEG),
                     a)
        a = a + np.where(pos == Ye,
                         np.where(np.asarray(allow_end)[None], 0.0, NEG),
                         0.0)
        if tail is not None:
            cond = (pos == L - 1) & (Ye == L)
            a = a + np.where(cond,
                             np.where(np.asarray(tail)[None], 0.0, NEG),
                             0.0)
        return a

    return dict(
        auxR=pin(m.r_start, m.r_end, m.r_tail),
        auxL=pin(m.l_start, m.l_end),
        auxPL=pin(m.pl_start, m.pl_end),
        auxPR=pin(m.pr_start, m.pr_end, m.pr_tail),
    )


def cyk_tables_batch_start(cfg: J.ModelConfig, params: J.Params, sd_b,
                    Ys_b, Ye_b):
    """Dispatch the chunk's CYK tables on device and start async host
    copies; returns an opaque handle for cyk_tables_batch_finish.  Split so the
    driver can overlap this chunk's fetch with the next chunk's device
    work."""
    from .scanner import state_masks
    # build the cached kernel/grammar/mask constants OUTSIDE the jit
    # trace — constructing them inside _cyk_tables_batch_jit's first
    # trace leaks tracers into the lru caches (crashes the 2nd chunk)
    J.kernels(cfg)
    state_masks(cfg)
    _cyk_kernel(cfg)
    import time
    t0 = time.time()
    tabs_b, d_b, c_b = _cyk_tables_batch_jit(
        cfg, params, sd_b, jnp.asarray(Ys_b), jnp.asarray(Ye_b))
    # aux pins are rebuilt on host: skip their transfer entirely
    d_small = d_b._replace(auxR=None, auxL=None, auxPL=None, auxPR=None)
    for leaf in jax.tree.leaves((tabs_b, d_small, c_b)):
        try:
            leaf.copy_to_host_async()
        except Exception:
            pass
    return (tabs_b, d_small, c_b,
            np.asarray(Ys_b).copy(), np.asarray(Ye_b).copy(), t0)


def cyk_tables_batch_finish(cfg: J.ModelConfig, handle, n_valid: int):
    """Block on the chunk's host copies and run the per-read host
    tracebacks.  Returns a list of n_valid (state_path, struct)."""
    from .scanner import state_masks
    import os
    import sys
    import time
    tabs_b, d_small, c_b, Ys_b, Ye_b, t0 = handle
    g = J.kernels(cfg).g
    m = state_masks(cfg)
    t1 = time.time()
    tabs_np = [np.asarray(t) for t in tabs_b]
    d_np = jax.tree.map(np.asarray, d_small)
    c_np = jax.tree.map(np.asarray, c_b)
    t2 = time.time()
    out = []
    for t in range(n_valid):
        row = lambda x: x[t]
        tabs_t = tuple(tab[t] for tab in tabs_np)
        d_t = jax.tree.map(row, d_np)
        c_t = jax.tree.map(row, c_np)
        aux = _pin_aux_np(cfg, g, m, int(Ys_b[t]), int(Ye_b[t]),
                          int(c_np.L[t]))
        d_t = d_t._replace(**aux)
        out.append(traceback(cfg, tabs_t, d_t, c_t))
    if os.environ.get("RNAELEM_SCAN_PROF"):
        print(f"cyk chunk n={n_valid}: dispatch->finish {t1-t0:.2f}s "
              f"fetch-wait {t2-t1:.2f}s traceback {time.time()-t2:.2f}s",
              file=sys.stderr, flush=True)
    return out


def viterbi_alignment_batch(cfg: J.ModelConfig, params: J.Params,
                            sd_b, Ys_b, Ye_b, n_valid: int):
    """Batched Viterbi: device DP over the whole chunk, one host fetch,
    per-read host tracebacks (see cyk_batch_start/finish)."""
    return cyk_tables_batch_finish(
        cfg, cyk_tables_batch_start(cfg, params, sd_b, Ys_b, Ye_b), n_valid)


# ---------------------------------------------------------------------
# Mark-based alignment: batch-minor max DP + cotangent path extraction
# (ops/dp_maxb.py).  Only ~L ints + an [Lp+1, Wp+1] pair indicator per
# read leave the device — the table-fetch + host argmax re-derivation
# above becomes the rare-tie fallback.
# ---------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _maxb_kernel(cfg: J.ModelConfig):
    from ..ops import dp_maxb as DMB
    k = J.kernels(cfg)
    tables_fn, marks_fn = DMB.build_max_tables(
        k.g, k.dims, k.tab, jnp.dtype(cfg.dtype))
    return tables_fn, marks_fn


@functools.partial(jax.jit, static_argnums=(0,))
def _cyk_marks_batch_jit(cfg: J.ModelConfig, params: J.Params, sd_b,
                         Ys_b, Ye_b):
    from .scanner import state_masks
    assert cfg.with_aux
    k = J.kernels(cfg)
    m = state_masks(cfg)
    dtype = jnp.dtype(cfg.dtype)
    bp_ok_b, _ = J._effective_bp_mask_batch_jit(cfg, sd_b)
    aux_b = jax.vmap(
        lambda ys, ye, L: _pin_aux(cfg, k.g, m, ys, ye, L, dtype)
    )(Ys_b, Ye_b, sd_b.L)
    d_b, c_b = J.batch_factors(cfg, params, sd_b, bp_ok_b, aux_b)
    return _maxb_kernel(cfg)[1](d_b, c_b)


def rss_from_pairs(pair_cells, L: int) -> str:
    """Structure string from the Viterbi pair set alone: every struct
    class of the traceback (motif_scanner.hpp:262-362) is a pure
    function of the pair nesting — L/R at pair ends; interior of a
    childless pair H; one child: empty-gap side bulge B else internal I;
    >=2 children: M; unenclosed O."""
    struct = ["O"] * L
    # cells are (j, w): pair bases i = j - w and j - 1
    spans = sorted(((int(j) - int(w), int(j)) for j, w in pair_cells),
                   key=lambda p: (p[0], -p[1]))
    stack = []
    children = {sp: [] for sp in spans}
    roots = []
    for sp in spans:
        while stack and sp[0] >= stack[-1][1]:
            stack.pop()
        (children[stack[-1]] if stack else roots).append(sp)
        stack.append(sp)
    for (i, j) in spans:
        struct[i] = "L"
        struct[j - 1] = "R"
        cs = children[(i, j)]
        inner = range(i + 1, j - 1)
        if not cs:
            for p in inner:
                struct[p] = "H"
        else:
            covered = np.zeros(L, bool)
            for (k, l) in cs:
                covered[k:l] = True
            mark = "M" if len(cs) >= 2 else (
                "B" if (cs[0][0] == i + 1 or cs[0][1] == j - 1) else "I")
            for p in inner:
                if not covered[p]:
                    struct[p] = mark
    return "".join(struct)


def cyk_batch_start(cfg: J.ModelConfig, params: J.Params, sd_b,
                    Ys_b, Ye_b):
    """Dispatch the chunk's mark-based Viterbi extraction; returns an
    opaque handle for cyk_batch_finish.  The device output is tiny
    (psihat ints + pair bits + ok flags), so the fetch that dominated
    the table-based path disappears."""
    from .scanner import state_masks
    J.kernels(cfg)
    state_masks(cfg)
    _maxb_kernel(cfg)
    import time
    t0 = time.time()
    out = _cyk_marks_batch_jit(cfg, params, sd_b,
                               jnp.asarray(Ys_b), jnp.asarray(Ye_b))
    for leaf in jax.tree.leaves(out):
        try:
            leaf.copy_to_host_async()
        except Exception:
            pass
    return (out, params, sd_b, np.asarray(Ys_b).copy(),
            np.asarray(Ye_b).copy(), t0)


def cyk_batch_finish(cfg: J.ModelConfig, handle, n_valid: int):
    """Assemble per-read (state_path, struct) from the device marks;
    reads whose marks report a tie (split argmax) re-run through the
    exact table-based host traceback."""
    import os
    import sys
    import time
    out, params, sd_b, Ys_b, Ye_b, t0 = handle
    t1 = time.time()
    psihat = np.asarray(out["psihat"])        # [Lp, B]
    pairs = np.asarray(out["pairs"])          # [Lp+1, Wp+1, B]
    ok = np.asarray(out["ok"])                # [B]
    L_b = np.asarray(sd_b.L)
    t2 = time.time()
    res = []
    n_fb = 0
    for t in range(n_valid):
        L = int(L_b[t])
        if ok[t]:
            cells = np.argwhere(pairs[:, :, t])
            res.append((psihat[:, t].copy(), rss_from_pairs(cells, L)))
        else:
            # tie fallback: exact argmax-order traceback on this read
            n_fb += 1
            sd = jax.tree.map(lambda x: np.asarray(x)[t], sd_b)
            res.append(viterbi_alignment(
                cfg, params, sd, int(Ys_b[t]), int(Ye_b[t])))
    if os.environ.get("RNAELEM_SCAN_PROF"):
        print(f"cyk marks n={n_valid}: dispatch->finish {t1-t0:.2f}s "
              f"fetch-wait {t2-t1:.2f}s assemble {time.time()-t2:.2f}s "
              f"fallbacks {n_fb}",
              file=sys.stderr, flush=True)
    return res
