"""Factorised internal-loop (TT_E_P) block.

The naive contraction gathers P/L cells per (w, dk, dl, q) — O(W*C^2*nq)
random gathers per column (50x slower than the C=2 band on the
accelerator this was first built for).  This module computes the same
sum exactly as dense products over static matrices:

* loop_energy (energy_param.hpp:744-795) is factorized by case:
    long loops:   misA[j,w] + misB[l,v] + internal[u1+u2] + ninio[|u1-u2|]
    bulges u>=2:  au_out[j,w] + au_in[l,v] + bulge[u]
  with per-cell tables misA/misB/au precomputed once per sequence, and
  the size term a tiny static matrix SZ[u1, u2];
* the six base-coupled cases — stack-adjacent bulges (0,1)/(1,0) and
  short internals (1,1)/(1,2)/(2,1)/(2,2) — are [w]-vector specials;
* the (dl, v) -> r = dl+v reduction with the Toeplitz size matrix is an
  exp/max-shift MATMUL against exp(lambda*SZ) (one per lambda bucket);
* motif-state quadruple picks are one-hot matmuls; DP cells are read via
  contiguous flipped row blocks plus one static-index shear.

Derivation of coordinates (cell (j, w) = span (i, j), i = j - w):
  inner pair P cell at column l = j - dl, width v; left gap u1 = dk =
  w - r with r = dl + v; right gap u2 = dl; left flank LL[j-r, w-r];
  right flank LL[j, dl].
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .semiring import NEG, lse, logadd, lam_mul

MAXLOOP = 30

# class groups sharing an outer (misA) table: 0=1n, 1=23, 2=i, 3=bulge/au
N_GROUPS = 4


class EpStatic(NamedTuple):
    SZ: np.ndarray      # [n_class, Cp+1(u1), Cp+1(u2)] log sizes, -inf out
    grp: np.ndarray     # [n_class] -> misA/misB table row (0..3)
    hot1: np.ndarray    # [S, nq] one-hot s1 (inner pair state)
    hot2: np.ndarray    # [S, nq] s2 (left flank)
    hot3: np.ndarray    # [S, nq] s3 (right flank)
    q_s: np.ndarray     # [nq] target E state
    q_b: np.ndarray     # [nq] lambda bucket of target
    qmask: np.ndarray   # [nq] 0 / -inf
    hot_seg: np.ndarray  # [nq, S] scatter one-hot for target states


def build_ep_static(g, Cp: int, energy_np, no_ene: bool) -> EpStatic:
    u1 = np.arange(Cp + 1)[:, None]
    u2 = np.arange(Cp + 1)[None, :]
    usum = u1 + u2
    if no_ene:
        SZ = np.where(usum >= 1, 0.0, -np.inf)[None]
        grp = np.array([3])
    else:
        internal = np.asarray(energy_np["internal"])
        ninio = np.asarray(energy_np["ninio"])
        bulge = np.asarray(energy_np["bulge"])
        uc = np.clip(usum, 0, MAXLOOP)
        lg = internal[uc] + ninio[np.clip(np.abs(u1 - u2), 0, MAXLOOP)]
        longok = (u1 >= 1) & (u2 >= 1) & (np.maximum(u1, u2) >= 3) \
            & (usum <= MAXLOOP)
        is1n = longok & ((u1 == 1) | (u2 == 1))
        is23 = longok & (usum == 5) & ~((u1 == 1) | (u2 == 1))
        isi = longok & ~is1n & ~is23
        bR = (u1 == 0) & (u2 >= 2) & (u2 <= MAXLOOP)
        bL = (u2 == 0) & (u1 >= 2) & (u1 <= MAXLOOP)
        SZ = np.stack([
            np.where(is1n, lg, -np.inf),
            np.where(is23, lg, -np.inf),
            np.where(isi, lg, -np.inf),
            np.where(bR, bulge[np.clip(u2, 0, MAXLOOP)], -np.inf),
            np.where(bL, bulge[np.clip(u1, 0, MAXLOOP)], -np.inf),
        ])
        grp = np.array([0, 1, 2, 3, 3])

    ep = g.ep_tuples
    if len(ep) == 0:
        ep = np.zeros((1, 4), np.int64)
        qmask = np.full(1, -np.inf)
    else:
        qmask = np.zeros(len(ep))
    S = g.S
    eye = np.eye(S)
    return EpStatic(
        SZ=SZ, grp=grp,
        hot1=eye[ep[:, 1]].T, hot2=eye[ep[:, 2]].T, hot3=eye[ep[:, 3]].T,
        q_s=ep[:, 0], q_b=g.lam_bucket[ep[:, 0]], qmask=qmask,
        hot_seg=eye[ep[:, 0]])


def seq_tables(tab, seq, Lp: int, Wp: int, no_ene: bool, dtype):
    """Per-sequence [4, Lp+1, Wp+1] mismatch/au tables + pair types.

    Outer cell (j, w): closing pair (i-1, j), i = j-w, mismatch bases
    (s[i], s[j-1]).  Inner cell (l, v): pair (k, l-1), k = l-v,
    type2 = bp(s[l-1], s[k]), mismatch bases (s[l], s[k-1]).
    """
    j = jnp.arange(Lp + 1)[:, None]
    w = jnp.arange(Wp + 1)[None, :]
    i = j - w
    sg = lambda idx: seq[jnp.clip(idx, 0, Lp - 1)]
    if no_ene:
        z = jnp.zeros((4, Lp + 1, Wp + 1), dtype)
        ti = jnp.zeros((Lp + 1, Wp + 1), jnp.int32)
        return dict(misA=z, misB=z, t_out=ti, t_in=ti,
                    spec_il=jnp.zeros((6, Lp + 1, Wp + 1), dtype))
    bp = tab["bp"]
    t_out = bp[sg(i - 1), sg(j + 0 * w)]
    b_i, b_jm = sg(i), sg(j - 1 + 0 * w)
    misA = jnp.stack([
        tab["mismatch_1n"][t_out, b_i, b_jm],
        tab["mismatch_23"][t_out, b_i, b_jm],
        tab["mismatch_i"][t_out, b_i, b_jm],
        jnp.where(t_out > 2, tab["term_au"], 0.0),
    ]).astype(dtype)
    l, v = j, w
    t_in = bp[sg(l - 1), sg(l - v)]
    b_l, b_km = sg(l + 0 * v), sg(l - v - 1)
    misB = jnp.stack([
        tab["mismatch_1n"][t_in, b_l, b_km],
        tab["mismatch_23"][t_in, b_l, b_km],
        tab["mismatch_i"][t_in, b_l, b_km],
        jnp.where(t_in > 2, tab["term_au"], 0.0),
    ]).astype(dtype)
    # base-coupled specials: per-(j, w) energies for the six (dk, dl)
    # combos (stack-adjacent bulges, 1x1/1x2/2x1/2x2 internals) hoisted
    # out of the column scan (energy_param.hpp:744-795).  Out-of-band
    # indices are clipped — those entries multiply zero DP weights.
    def idx2(joff, woff):
        return t_in[jnp.clip(j - joff, 0, Lp),
                    jnp.clip(w - woff, 0, Wp)]

    b_i = sg(i)
    b_i1 = sg(i + 1)
    b_jm = sg(j - 1 + 0 * w)
    b_j2 = sg(j - 2 + 0 * w)
    bulge1 = tab["bulge"][1]
    spec_il = jnp.stack([
        bulge1 + tab["stack"][t_out, idx2(1, 1)],            # (0,1)
        bulge1 + tab["stack"][t_out, idx2(0, 1)],            # (1,0)
        tab["int11"][t_out, idx2(1, 2), b_i, b_jm],          # (1,1)
        tab["int21"][t_out, idx2(2, 3), b_i, b_j2, b_jm],    # (1,2)
        tab["int21"][idx2(1, 3), t_out, b_jm, b_i, b_i1],    # (2,1)
        tab["int22"][t_out, idx2(2, 4), b_i, b_i1,
                     b_j2, b_jm],                            # (2,2)
    ]).astype(dtype)
    return dict(misA=misA, misB=misB,
                t_out=t_out.astype(jnp.int32),
                t_in=t_in.astype(jnp.int32),
                spec_il=spec_il)


def _flip_rows(T, j, nrows: int):
    """F[r] = T[j - r] for r = 0..nrows-1 (pad + dynamic slice + flip)."""
    pad = jnp.full((nrows,) + T.shape[1:], NEG, T.dtype)
    Tp = jnp.concatenate([pad, T], axis=0)
    blk = jax.lax.dynamic_slice_in_dim(Tp, j + 1, nrows, axis=0)
    return blk[::-1]


def _logmm_exp(A, expB, axis_size):
    """out[..., u] = log( sum_dl exp(A[..., dl]) * expB[dl, u] ) with
    max-shift over dl; NaN-safe for all--inf rows."""
    m = jax.lax.stop_gradient(jnp.max(A, axis=-1, keepdims=True))
    m0 = jnp.where(jnp.isfinite(m), m, 0.0)
    ea = jnp.exp(A - m0)
    s = jnp.einsum("...d,du->...u", ea, expB,
                   preferred_element_type=A.dtype)
    tiny = jnp.finfo(A.dtype).tiny
    return jnp.where(s > 0, m0 + jnp.log(jnp.maximum(s, tiny)), NEG)


def make_ep_term(g, dims, energy_tab, est: EpStatic, dtype):
    """Returns ep_term(d, c, j, Pt, LLt, Lcol) -> [Wp+1, S] for the sum
    semiring (the max/CYK path keeps the reference-shaped enumeration)."""
    Wp, Cp, S = dims.Wp, dims.Cp, g.S
    nq = est.hot1.shape[1]
    n_cls = est.SZ.shape[0]
    SZ = jnp.asarray(est.SZ, dtype)
    hot1 = jnp.asarray(est.hot1, dtype)
    hot2 = jnp.asarray(est.hot2, dtype)
    hot3 = jnp.asarray(est.hot3, dtype)
    hot_seg = jnp.asarray(est.hot_seg, dtype)
    q_s = jnp.asarray(est.q_s)
    q_b = jnp.asarray(est.q_b)
    qmask = jnp.asarray(est.qmask, dtype)
    grp = est.grp
    warr = jnp.arange(Wp + 1)
    dlarr = jnp.arange(Cp + 1)
    no_ene = dims.no_ene
    fix_rss = dims.fix_rss

    # static shear indices
    wr_idx = jnp.clip(warr[None, :] - warr[:, None], 0, Wp)   # [r, w]
    wr_ok = warr[None, :] >= warr[:, None]
    rv_idx = jnp.clip(warr[None, :] - dlarr[:, None], 0, Wp)  # [dl, r]
    rv_ok = warr[None, :] >= dlarr[:, None]
    u1_idx = jnp.clip(warr[None, :] - warr[:, None], 0, Cp)   # [r, w]
    u1_ok = (warr[None, :] - warr[:, None] >= 0) & \
        (warr[None, :] - warr[:, None] <= Cp)

    # one-hot matmuls cannot see -inf (0 * inf = NaN): clamp to a huge
    # finite negative that behaves as log(0) under every later exp/lse
    BIG_NEG = -float(jnp.finfo(dtype).max) / 1e8

    def pick(blk, hot):
        return jnp.einsum("...s,sq->...q", jnp.maximum(blk, BIG_NEG),
                          hot, preferred_element_type=dtype)

    def shift_w(row, k):
        """out[w] = row[w - k] (static shift along a [Wp+1] axis)."""
        if k == 0:
            return row
        fill = 0 if jnp.issubdtype(row.dtype, jnp.integer) else NEG
        pad = jnp.full((k,) + row.shape[1:], fill, row.dtype)
        return jnp.concatenate([pad, row[:-k]], axis=0)

    def ep_term(d, c, j, Pt, LLt, Lcol):
        lam = d.lam
        ept = c.ep
        C = c.C
        dcum = c.dots_cum

        PF = _flip_rows(Pt, j, Cp + 1)           # [dl, v, S]
        LB = _flip_rows(LLt, j, Wp + 1)          # [m, d, S]
        misA = jax.lax.dynamic_index_in_dim(
            ept["misA"], j, axis=1, keepdims=False)   # [4, Wp+1]
        mBblk = _flip_rows(ept["misB"].transpose(1, 0, 2), j, Cp + 1)
        misB = mBblk.transpose(1, 0, 2)          # [4, dl, v]

        # Dleft[r, w, s] = LL[j-r, w-r, s]
        Dleft = jnp.take_along_axis(
            LB, wr_idx[:, :, None], axis=1)
        Dleft = jnp.where(wr_ok[:, :, None], Dleft, NEG)
        if fix_rss:
            # ld[r, w]: left flank [i, j-r) all dots
            # <=> dcum[j-r] - dcum[j-w] == w - r
            ld = (dcum[jnp.clip(j - warr[:, None], 0, None)]
                  - dcum[jnp.clip(j - warr[None, :], 0, None)]
                  ) == (warr[None, :] - warr[:, None])
            Dleft = jnp.where(ld[:, :, None], Dleft, NEG)
            rd = (dcum[j] - dcum[jnp.clip(j - dlarr, 0, None)]) == dlarr
        else:
            rd = None

        # state parts
        p1 = pick(PF, hot1)                      # [dl, v, nq]
        l3 = pick(Lcol[: Cp + 1], hot3)          # [dl, nq]
        if rd is not None:
            l3 = jnp.where(rd[:, None], l3, NEG)
        inner = p1 + l3[:, None, :]              # [dl, v, nq]
        # shear to [r, dl, nq]: v = r - dl
        inner2 = jnp.take_along_axis(inner, rv_idx[:, :, None], axis=1)
        inner2 = jnp.where(rv_ok[:, :, None], inner2, NEG)
        inner2 = inner2.transpose(1, 0, 2)       # [r, dl, nq]

        # per class: V[r, u1, nq] via exp-matmul against exp(lam*SZ)
        cmask = (dlarr[:, None] + dlarr[None, :]) <= C  # [u1, u2]
        Vg = [None] * N_GROUPS
        for x in range(n_cls):
            szx = jnp.where(cmask, SZ[x], NEG).T  # [u2=dl, u1]
            mb = misB[grp[x]]                    # [dl, v]
            mb2 = jnp.take_along_axis(mb, rv_idx, axis=1)  # [dl, r]
            mb2 = jnp.where(rv_ok, mb2, NEG).T   # [r, dl]
            Vb = []
            for b in range(2):
                eSZ = jnp.exp(lam_mul(lam[b], szx))  # [dl, u1]
                Ab = inner2 + lam_mul(lam[b], mb2)[:, :, None]
                Ab = Ab + jnp.where(q_b[None, None, :] == b, 0.0, NEG)
                Vb.append(_logmm_exp(
                    Ab.transpose(0, 2, 1), eSZ, Cp + 1))  # [r, nq, u1]
            V = logadd(Vb[0], Vb[1]).transpose(0, 2, 1)  # [r, u1, nq]
            gx = grp[x]
            Vg[gx] = V if Vg[gx] is None else logadd(Vg[gx], V)

        # combine with the left flank; u1 = w - r
        Dq = pick(Dleft, hot2)                   # [r, w, nq]
        out_q = jnp.full((Wp + 1, nq), NEG, dtype)
        for gxi in range(N_GROUPS):
            if Vg[gxi] is None:
                continue
            Vsh = jnp.take_along_axis(
                Vg[gxi], u1_idx[:, :, None], axis=1)  # [r, w, nq]
            Vsh = jnp.where(u1_ok[:, :, None], Vsh, NEG)
            Ex = lse(Dq + Vsh, axis=0)           # [w, nq]
            mA = lam_mul(lam[q_b][None, :], misA[gxi][:, None])
            out_q = logadd(out_q, Ex + mA)

        # specials: base-coupled (dk, dl) combos
        if not no_ene:
            seq = c.seq
            Lp = seq.shape[0]
            sg = lambda idx: seq[jnp.clip(idx, 0, Lp - 1)]
            tab = energy_tab
            t_out = jax.lax.dynamic_index_in_dim(
                ept["t_out"], j, axis=0, keepdims=False)  # [w]
            t_in = ept["t_in"]
            i_w = j - warr
            b_i = sg(i_w)
            b_jm = sg((j - 1) + 0 * warr)
            tin_row = lambda lcol: jax.lax.dynamic_index_in_dim(
                t_in, jnp.maximum(lcol, 0), axis=0, keepdims=False)

            def tin_at(lcol, voff):
                # t_in[l, v] with v = w - voff (a shifted [w]-vector)
                row = tin_row(lcol)
                return shift_w(row, voff)

            def spec(dk, dl, il_w):
                # left flank LL[j-w+dk, dk] -> LB[w-dk, dk]
                lf = shift_w(LB[:, dk, :], dk)           # [w, S]
                pin = shift_w(PF[dl], dk + dl)           # [w, S]
                term = (pick(lf, hot2) + pick(pin, hot1)
                        + pick(Lcol[dl], hot3)[None, :])
                ilq = lam_mul(lam[q_b][None, :], il_w[:, None])
                ok = (dk + dl) <= C
                t = jnp.where(ok, term + ilq, NEG)
                if fix_rss:
                    ldok = (dcum[jnp.clip(j - warr + dk, 0, None)]
                            - dcum[jnp.clip(j - warr, 0, None)]) == dk
                    rdok = (dcum[j]
                            - dcum[jnp.clip(j - dl, 0, None)]) == dl
                    t = jnp.where(ldok[:, None] & rdok, t, NEG)
                return t

            bulge1 = tab["bulge"][1]
            sp = []
            sp.append(spec(0, 1, bulge1
                           + tab["stack"][t_out, tin_at(j - 1, 1)]))
            sp.append(spec(1, 0, bulge1
                           + tab["stack"][t_out, tin_at(j, 1)]))
            sp.append(spec(1, 1, tab["int11"][
                t_out, tin_at(j - 1, 2), b_i, b_jm]))
            sp.append(spec(1, 2, tab["int21"][
                t_out, tin_at(j - 2, 3), b_i, sg((j - 2) + 0 * warr),
                b_jm]))
            sp.append(spec(2, 1, tab["int21"][
                tin_at(j - 1, 3), t_out, sg((j - 1) + 0 * warr), b_i,
                sg(i_w + 1)]))
            sp.append(spec(2, 2, tab["int22"][
                t_out, tin_at(j - 2, 4), b_i, sg(i_w + 1),
                sg((j - 2) + 0 * warr), b_jm]))
            for t in sp:
                out_q = logadd(out_q, t)

        out_q = out_q + qmask[None, :]
        # scatter-lse into target states via one-hot matmul
        m = jax.lax.stop_gradient(jnp.max(out_q, axis=-1, keepdims=True))
        m0 = jnp.where(jnp.isfinite(m), m, 0.0)
        es = jnp.einsum("wq,qs->ws", jnp.exp(out_q - m0), hot_seg,
                        preferred_element_type=dtype)
        tiny = jnp.finfo(dtype).tiny
        # per-target max shift differs per q; redo with global row max:
        out = jnp.where(es > 0, m0 + jnp.log(jnp.maximum(es, tiny)), NEG)
        return out

    return ep_term
