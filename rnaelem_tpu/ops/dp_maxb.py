"""Batched max-semiring (Viterbi/CYK) inside DP — batch-minor.

The CYK twin of ops/dp.py: one ``lax.scan`` over sequence columns
computes the max-semiring recursion of the reference scanner
(CYKFun, motif_scanner.hpp:802-913) for a WHOLE BATCH of reads, with the
batch axis minor as in ops/dp.py.  The per-read CYK kernel
(ops/dp_max.py, under ``jax.vmap``) has [.., S=~29] minor dims and
per-column full-table flips; on the accelerator it was built for, that
made its device pass ~50x slower per read than the sum kernel.

Forward only: the traceback re-derives per-cell argmaxes (scan/cyk.py)
so no reverse pass or trace tensors are needed.  Max replaces the sum
path's exp-space matmuls with broadcast-add + max-reduce (XLA fuses
the broadcasts into the reductions), and the TT_E_P quadruple sum
uses the same pairs13 -> AR -> K2 chain factorization as ops/dp.py —
max distributes over + exactly like sum distributes over *, and
``lam >= 0`` (bounds-clipped) lets the internal-loop energy classes be
max-reduced before the lambda multiply (lam * max == max * lam).

Consumes the SAME batch-minor DiffFactors/ConstFactors as ops/dp.py
(model/joint.batch_factors), so the scanner shares one factor build
between the posterior and alignment passes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .semiring import NEG, lam_mul, mask_neg
from .ep_fast import build_ep_static
from .dp import Dims, DiffFactors, ConstFactors, _shift_w, _shear


def _flip(T, j, n, PAD):
    """rows j, j-1, ..., j-n+1 of a front-padded table."""
    blk = jax.lax.dynamic_slice_in_dim(T, j + PAD - n + 1, n, axis=0)
    return blk[::-1]


def _segmax(x, seg_ids, num, axis):
    """segment-max along ``axis`` (static small segment count)."""
    x = jnp.moveaxis(x, axis, 0)
    out = jax.ops.segment_max(x, seg_ids, num_segments=num)
    return jnp.moveaxis(out, 0, axis)


def build_max_tables(g, dims: Dims, energy_tab, dtype=jnp.float32):
    """Returns (tables, marks):
    tables(d, c) -> 8 batch-minor inside tables (max semiring) in the
    dp_max row layout (row j at index j);
    marks(d, c) -> Viterbi-path marks via max-cotangents (see marks)."""
    dtype = jnp.zeros((), dtype).dtype
    Lp, Wp, Cp, S = dims.Lp, dims.Wp, dims.Cp, dims.S
    PAD = Wp + 1
    ltau = dims.ltau

    diag = jnp.asarray(g.diag_mask)
    loopm = jnp.asarray(g.loop_mask)
    bucket_np = g.lam_bucket
    bucket = jnp.asarray(bucket_np)
    end_states = jnp.asarray(g.end_states)
    warr = jnp.arange(Wp + 1)
    dlarr = jnp.arange(Cp + 1)
    diag_col = jnp.where(diag, 0.0, NEG).astype(dtype)

    # log-space static transition matrices (target, source)
    TRl = jnp.asarray(np.where(g.rt, np.where(g.rt_tau, ltau, 0.0),
                               -np.inf), dtype)
    TLl = jnp.asarray(np.where(g.lt, np.where(g.lt_tau, ltau, 0.0),
                               -np.inf), dtype)
    TPm = jnp.asarray(np.where(g.pt_tau, ltau, 0.0), dtype)
    pt_mask = jnp.asarray(g.pt)
    pt_isbp = jnp.asarray(g.pt_isbp)
    pt_tabd = jnp.asarray(np.maximum(g.pair_table_index[g.pt_tab], 0))
    pt_wl = jnp.asarray(g.pt_wl)
    pt_wr = jnp.asarray(g.pt_wr)

    # --- TT_E_P chain factorization (shared geometry with ops/dp.py) --
    ep_all = g.ep_tuples if len(g.ep_tuples) else \
        np.zeros((0, 4), np.int64)
    l_, r_ = g.state_l, g.state_r
    pairs13 = sorted(set((int(q[1]), int(q[3])) for q in ep_all))
    ar_list = sorted(set((int(l_[q[1]]), int(r_[q[3]])) for q in ep_all))
    ar_of = {p: i for i, p in enumerate(ar_list)}
    k2_list = sorted(set(
        (int(q[2]), ar_of[(int(l_[q[1]]), int(r_[q[3]]))])
        for q in ep_all))
    n13, n_ar, n2 = len(pairs13), len(ar_list), len(k2_list)
    have_ep = n13 > 0
    if have_ep:
        p13_s1 = jnp.asarray([p[0] for p in pairs13])
        p13_s3 = jnp.asarray([p[1] for p in pairs13])
        p13_ar = jnp.asarray(
            [ar_of[(int(l_[p[0]]), int(r_[p[1]]))] for p in pairs13])
        k2_s2 = jnp.asarray([k[0] for k in k2_list])
        k2_ar = jnp.asarray([k[1] for k in k2_list])
        k2_tgt_np = np.array([
            int(g.n2s[l_[s2], ar_list[ai][1]]) for s2, ai in k2_list])
        assert (k2_tgt_np >= 0).all()
        k2_tgt = jnp.asarray(k2_tgt_np)
        lamk2_idx = jnp.asarray(bucket_np[k2_tgt_np])

    # internal-loop energy size classes
    energy_np = {k: np.asarray(v) for k, v in energy_tab.items()
                 if k in ("internal", "ninio", "bulge")}
    est = build_ep_static(g, Cp, energy_np, dims.no_ene)
    n_cls = est.SZ.shape[0]
    grp = est.grp
    # SZT[cls][dl(u2), u1]
    SZT = [jnp.asarray(est.SZ[x].T, dtype) for x in range(n_cls)]
    ru_np = np.arange(Wp + 1)[:, None] + np.arange(Cp + 1)[None, :]
    ru_ok = jnp.asarray(ru_np <= Wp)
    ruj = jnp.asarray(np.minimum(ru_np, Wp))      # w = x + u1

    SPEC_COMBOS = ((0, 1), (1, 0), (1, 1), (1, 2), (2, 1), (2, 2))

    def _lam2(lam):
        return lam if lam.ndim == 2 else lam[:, None]

    def chain(src, eRrow, TRx):
        """out[w,t,b] = max_s src[w,s,b] + TRx[t,s(,b)] + eR[t,b]."""
        if TRx.ndim == 2:
            t = src[:, None, :, :] + TRx[None, :, :, None]
        else:
            t = src[:, None, :, :] + TRx[None]
        return jnp.max(t, axis=2) + eRrow[None]

    def chain1(src, eRrow, TRx, extra):
        if TRx.ndim == 2:
            t = src[None, :, :] + TRx[:, :, None]
        else:
            t = src[None, :, :] + TRx
        return jnp.max(t, axis=1) + eRrow + extra

    def p_col(d, c, j, i_of_w, prevE2, prevP2, lamv, rows):
        """pem[w,t,s,b] built dense (profile_hmm.hpp:113-135), then
        max-reduced against the shifted E/P rows."""
        iw = jnp.clip(i_of_w, 0, Lp - 1)
        jm = jnp.clip(j - 1, 0, Lp - 1)
        bgl = d.bg2[iw]                              # [w, B]
        bgr = d.bg2[jm]                              # [B]
        bg_part = (bgl[:, None, None, :] + bgr[None, None, None, :])
        pvj = d.pv[j]                                # [w, Tp, B]
        bp_part = pvj[:, pt_tabd, :]                 # [w, t, s, B]
        wl = c.wsp[iw][:, None, None, :]
        wr = c.wsp[jm][None, None, None, :]
        bp_part = bp_part + jnp.where(pt_wl[None, :, :, None], wl, 0.0) \
            + jnp.where(pt_wr[None, :, :, None], wr, 0.0)
        pem = jnp.where(pt_isbp[None, :, :, None], bp_part, bg_part)
        pem = jnp.where(pt_mask[None, :, :, None],
                        pem + TPm[None, :, :, None], NEG)
        if dims.with_aux:
            # aux rows index to [w, t, s, B]
            pem = pem + rows["auxPL"] + rows["auxPR"][None]
        a_pe = jnp.max(pem + prevE2[:, None, :, :], axis=2)
        a_pp = jnp.max(pem + prevP2[:, None, :, :], axis=2)
        a_pp = a_pp + lam_mul(lamv[None], c.stk[j][:, None, :])
        Pcol = jnp.maximum(a_pe, a_pp) + rows["alphaP"][:, None, :]
        return mask_neg(Pcol, c.okP[j][:, None, :])

    if len(g.b12_tuples):
        b12_t = jnp.asarray(g.b12_tuples[:, 0])
        b12_a = jnp.asarray(g.b12_tuples[:, 1])
        b12_c = jnp.asarray(g.b12_tuples[:, 2])
        nb12 = len(g.b12_tuples)
    else:
        nb12 = 0

    # tuple/chain axes are chunked so no broadcast temp (or its VJP
    # indicator) exceeds ~128 MB: long all-dot motifs blow these spaces
    # up (pattern '..........': S=78, n_ar=78, n2=364 — the unchunked
    # ep_col V step alone would need ~62 GB of HLO temp at B=64)
    B12C, P13C, ARC, K2C = 128, 256, 8, 256

    def b_col(c, j, T1F, T2col, B):
        """B(i,j) = max_k 1(i,k) + 2(k,j) over TT_B_12 tuples."""
        if nb12 == 0:
            return jnp.full((Wp + 1, S, B), NEG, dtype)
        X1 = _shear(T1F.at[0].set(NEG), Wp + 1, NEG)  # [dk, w, S, B]
        T2m = T2col.at[0].set(NEG)                    # width >= 1
        Bcol = jnp.full((Wp + 1, S, B), NEG, dtype)
        for q0 in range(0, nb12, B12C):
            q1 = min(q0 + B12C, nb12)
            Y = X1[:, :, b12_a[q0:q1], :] \
                + T2m[:, None, b12_c[q0:q1], :]       # [dk, w, nc, B]
            Ymax = jnp.max(Y, axis=0)                 # [w, nc, B]
            Bcol = jnp.maximum(
                Bcol, _segmax(Ymax, b12_t[q0:q1], S, axis=1))
        return mask_neg(Bcol, c.okB[j][:, None, :])

    def m_col(d, c, j, Bcol, B, rows):
        iw = jnp.clip(j - warr, 0, Lp - 1)
        eLrows = d.eL[iw]                        # [w, S, B] source-keyed
        gMs = c.gate_M[iw]                       # [w, B]
        bvecs = mask_neg(Bcol, c.okM[j][:, None, :])
        okMj = c.okM[j]
        auxLrows = rows["auxL"] if dims.with_aux else None

        def m_step(x, blk):
            if dims.with_aux:
                eb, gb, bb, ob, ab = blk
                t = x[None, :, :] + TLl[:, :, None] + eb[None, :, :] \
                    + gb[None, None, :] + ab
            else:
                eb, gb, bb, ob = blk
                t = x[None, :, :] + TLl[:, :, None] + eb[None, :, :] \
                    + gb[None, None, :]
            cur = mask_neg(jnp.maximum(bb, jnp.max(t, axis=1)),
                           ob[None, :])
            return cur, cur

        xs = (eLrows, gMs, bvecs, okMj) if not dims.with_aux else \
            (eLrows, gMs, bvecs, okMj, auxLrows)
        _, Mcol = jax.lax.scan(m_step, jnp.full((S, B), NEG, dtype), xs)
        return Mcol

    def ep_col(d, c, j, PF, LB, Lcol, B):
        """TT_E_P internal-loop max (motif_scanner.hpp:875-905), chain-
        factored like ops/dp.py ep_col but with max-reductions."""
        if not have_ep:
            return jnp.full((Wp + 1, S, B), NEG, dtype)
        lam = _lam2(d.lam)
        ept = c.ep
        # right flank LL(j, dl), with the fix_rss all-dots mask
        L3 = Lcol[: Cp + 1]                        # [dl, S, B]
        dcum = c.dots_cum
        if dims.fix_rss:
            rd = (dcum[j] - dcum[jnp.clip(j - dlarr, 0, None)]
                  ) == dlarr[:, None]
            L3 = jnp.where(rd[:, None, :], L3, NEG)
        # T stage: inner pair x right flank -> AR (p13 chunked)
        T = jnp.full((Cp + 1, Wp + 1, n_ar, B), NEG, dtype)
        for q0 in range(0, n13, P13C):
            q1 = min(q0 + P13C, n13)
            T13 = PF[:, :, p13_s1[q0:q1], :] \
                + L3[:, p13_s3[q0:q1], :][:, None]  # [dl, v, nc, B]
            T = jnp.maximum(
                T, _segmax(T13, p13_ar[q0:q1], n_ar, axis=2))
        Tsh = _shear(T, Wp + 1, NEG)               # [dl, x, n_ar, B]

        # energy weight W[dl, x, u1, B] = max over classes of
        # misB(inner) + size/asymmetry + misA(outer, w = x + u1);
        # classes max-reduce BEFORE the lambda multiply (lam >= 0)
        mA = c.ep["misA"][:, j]                    # [4, w, B]
        mBsh = _shear(_flipB(ept["misB"], j), Wp + 1, NEG)  # [dl,x,4,B]
        wA = [jnp.where(ru_ok[:, :, None], mA[g_][ruj], NEG)
              for g_ in range(4)]                  # [x, u1, B]
        Wall = None
        for x_ in range(n_cls):
            g_ = grp[x_]
            t = (mBsh[:, :, g_, None, :]
                 + SZT[x_][:, None, :, None]
                 + wA[g_][None, :, :, :])          # [dl, x, u1, B]
            Wall = t if Wall is None else jnp.maximum(Wall, t)
        # per-read C cap: u1 + u2 <= C
        cmask = (dlarr[:, None, None] + dlarr[None, :, None]
                 <= c.C[None, None, :])            # [dl(u2), u1, B]
        Wall = jnp.where(cmask[:, None, :, :], Wall, NEG)

        # V_bu[x, u1, ar, B] = max_dl Tsh + lam_bu * Wall (ar chunked:
        # the 5-D broadcast is the kernel's largest temp)
        V_bu = []
        for b in range(2):
            Wl = lam_mul(lam[b][None, None, None, :], Wall)
            parts = []
            for a0 in range(0, n_ar, ARC):
                a1 = min(a0 + ARC, n_ar)
                parts.append(jnp.max(
                    Tsh[:, :, None, a0:a1, :] + Wl[:, :, :, None, :],
                    axis=0))
            V_bu.append(jnp.concatenate(parts, axis=2))
        Vcat = jnp.concatenate(V_bu, axis=2)       # [x, u1, 2*n_ar, B]

        # left flank LL(j-x, u1) and the K2 stage
        LBc = LB[:, : Cp + 1]                      # [x, u1, S, B]
        if dims.fix_rss:
            ld = (dcum[jnp.clip(j - warr[:, None], 0, None)]
                  - dcum[jnp.clip(j - warr[:, None] - dlarr[None, :],
                                  0, None)]) == dlarr[None, :, None]
            LBc = jnp.where(ld[:, :, None, :], LBc, NEG)
        # K2 stage, chunked over the quadruple targets:
        # outw[w, k2, B] = max_u1 (LBc + Vcat)[w - u1, u1]
        arcat = lamk2_idx * n_ar + k2_ar
        out = jnp.full((Wp + 1, S, B), NEG, dtype)
        for q0 in range(0, n2, K2C):
            q1 = min(q0 + K2C, n2)
            G2 = LBc[:, :, k2_s2[q0:q1], :] \
                + Vcat[:, :, arcat[q0:q1], :]      # [x, u1, nc, B]
            G2u = jnp.moveaxis(G2, 1, 0)           # [u1, x, nc, B]
            G2sh = _shear(G2u, Wp + 1, NEG)        # [u1, w, nc, B]
            outw = jnp.max(G2sh, axis=0)           # [w, nc, B]
            out = jnp.maximum(
                out, _segmax(outw, k2_tgt[q0:q1], S, axis=1))
        if not dims.no_ene:
            spec = _ep_specials(d, c, j, PF, LBc, L3, lam, B)
            out = jnp.maximum(out, _segmax(spec, k2_tgt, S, axis=1))
        return out

    def _flipB(misB, j):
        """rows j..j-Cp of the [4, Lp+1, v, B] misB tensor as
        [dl, v, 4, B] (dl-th row = j - dl)."""
        blk = jax.lax.dynamic_slice_in_dim(
            jnp.pad(misB, ((0, 0), (Cp + 1, 0), (0, 0), (0, 0)),
                    constant_values=NEG),
            j + 1, Cp + 1, axis=1)
        return blk[:, ::-1].transpose(1, 2, 0, 3)

    def _ep_specials(d, c, j, PF, LBc, L3, lam, B):
        """Base-coupled bulges/small internals (energy_param.hpp:744-795)
        at their precomputed per-(j, w) energies (ep_fast.seq_tables),
        max-composed in the same K2 space; returns [w, n2, B]."""
        lamk2 = lam[lamk2_idx]                     # [n2, 1 or B]
        il6 = c.ep["spec_il"][:, j]                # [6, w, B]
        acc = jnp.full((Wp + 1, n2, B), NEG, dtype)
        for ci, (dk, dl) in enumerate(SPEC_COMBOS):
            lf = _shift_w(LBc[:, dk], dk)          # [w, S, B]
            pin = _shift_w(PF[dl], dk + dl)        # [w, S, B]
            tP = pin[:, p13_s1, :]                 # [w, n13, B]
            tL = L3[dl, p13_s3, :]                 # [n13, B]
            tar = _segmax(tP + tL[None], p13_ar, n_ar, axis=1)
            pL = lf[:, k2_s2, :]                   # [w, n2, B]
            pV = tar[:, k2_ar, :]
            eil = lam_mul(lamk2[None], il6[ci][:, None, :])
            ok = ((dk + dl) <= c.C)                # [B]
            t = jnp.where(ok[None, None, :], pL + pV + eil, NEG)
            acc = jnp.maximum(acc, t)
        return acc

    if len(g.op_tuples):
        op_t = jnp.asarray(g.op_tuples[:, 0])
        op_a = jnp.asarray(g.op_tuples[:, 1])
        op_c = jnp.asarray(g.op_tuples[:, 2])
        op_bu = jnp.asarray(bucket_np[g.op_tuples[:, 0]])
        nop = len(g.op_tuples)
    else:
        nop = 0

    def o_col(d, c, j, Orows, Pcol, eRrow, g_o2, aRt, B):
        oo = chain1(Orows[1], eRrow, aRt, g_o2[None, :])
        if nop == 0:
            return oo
        lam = _lam2(d.lam)
        # ext weight per bucket: [2, w, B]
        extw = jnp.stack([lam_mul(lam[b], c.ext[j]) for b in range(2)])
        Y = (Pcol[:, op_a, :] + Orows[:, op_c, :]
             + extw[op_bu, :, :].transpose(1, 0, 2))   # [w, nop, B]
        Ymax = jnp.max(Y, axis=0)                      # [nop, B]
        op_term = jax.ops.segment_max(Ymax, op_t, num_segments=S)
        return jnp.maximum(oo, op_term)

    def windows_of(tabs, j):
        LLt, Pt, Et, Mt, Bt, T1t, T2t, Ot = tabs
        return dict(
            L=_flip(LLt, j - 1, Wp, PAD),
            P=_flip(Pt, j - 1, Cp, PAD),
            T1=_flip(T1t, j - 1, Wp, PAD),
            E=Et[j - 1 + PAD],
            T2=T2t[j - 1 + PAD],
            O=_flip(Ot, j - 1, Wp, PAD),
        )

    def col_rows(d: DiffFactors, j):
        """The aux/alphaP row slices column j reads — routed through a
        dict so the reverse (mark-extraction) scan can take cotangents
        of ROWS per column instead of whole tensors (ops/dp.py
        col_rows rationale)."""
        iw = jnp.clip(j - warr, 0, Lp - 1)
        jm = jnp.clip(j - 1, 0, Lp - 1)
        rows = dict(alphaP=d.alphaP[j])
        if dims.with_aux:
            rows.update(
                auxR=d.auxR[jm], auxPR=d.auxPR[jm],
                auxL=d.auxL[iw], auxPL=d.auxPL[iw])
        return rows

    def cols_fn(win, j, rows, d, c):
        i_of_w = j - warr
        lamv = _lam2(d.lam)[bucket]                # [S, 1 or B]
        jm = jnp.clip(j - 1, 0, Lp - 1)
        eRrow = d.eR[jm]                           # [S, B]
        aRt = TRl[:, :, None] + rows["auxR"] if dims.with_aux else TRl
        g_o2 = c.gate_O2[jm]                       # [B]
        B = eRrow.shape[-1]
        negcol = jnp.full((1, Wp + 1, S, B), NEG, dtype)

        Lcol = chain(_shift_w(win["L"][0], 1), eRrow, aRt)
        Lcol = Lcol.at[0].set(diag_col[:, None])

        Pcol = p_col(d, c, j, i_of_w, _shift_w(win["E"], 2),
                     _shift_w(win["P"][0], 2), lamv, rows)

        T2col = jnp.maximum(
            chain(_shift_w(win["T2"], 1), eRrow, aRt)
            + g_o2[None, None, :],
            Pcol + lam_mul(lamv[None], c.ml2[j][:, None, :]))
        T2col = mask_neg(T2col, c.okB[j][:, None, :])

        T1F = jnp.concatenate([negcol, win["T1"]], axis=0)
        Bcol = b_col(c, j, T1F, T2col, B)

        T1col = mask_neg(jnp.maximum(T2col, Bcol),
                         c.okB[j][:, None, :])

        Mcol = m_col(d, c, j, Bcol, B, rows)

        hterm = jnp.where(
            loopm[None, :, None],
            Lcol + lam_mul(lamv[None], c.hp[j][:, None, :]), NEG)
        mterm = Mcol + lam_mul(lamv[None], c.mlE[j][:, None, :])
        PF = jnp.concatenate([Pcol[None], win["P"]], axis=0)[: Cp + 1]
        LB = jnp.concatenate([Lcol[None], win["L"]], axis=0)
        ep_term = ep_col(d, c, j, PF, LB, Lcol, B)
        Ecol = jnp.maximum(jnp.maximum(hterm, mterm), ep_term)
        Ecol = mask_neg(Ecol, c.okE[j][:, None, :])

        Orows = jnp.concatenate(
            [jnp.full((1, S, B), NEG, dtype), win["O"]], axis=0)
        Ocol = o_col(d, c, j, Orows, Pcol, eRrow, g_o2, aRt, B)

        return dict(L=Lcol, P=Pcol, E=Ecol, M=Mcol, B=Bcol,
                    T1=T1col, T2=T2col, O=Ocol)

    def col_update(tabs, j, d, c):
        cols = cols_fn(windows_of(tabs, j), j, col_rows(d, j), d, c)
        order = ("L", "P", "E", "M", "B", "T1", "T2", "O")
        return tuple(
            jax.lax.dynamic_update_slice_in_dim(
                T, cols[k][None], j + PAD, axis=0)
            for T, k in zip(tabs, order))

    def init_tabs(B):
        z3 = jnp.full((Lp + 1 + PAD, Wp + 1, S, B), NEG, dtype)
        LLt = z3.at[PAD:, 0, :, :].set(diag_col[:, None])
        Ot = jnp.full((Lp + 1 + PAD, S, B), NEG, dtype)
        Ot = Ot.at[PAD].set(
            jnp.where(jnp.arange(S)[:, None] == end_states[0], 0.0, NEG)
            .astype(dtype))
        return (LLt, z3, z3, z3, z3, z3, z3, Ot)

    def _forward(d, c):
        B = c.wsp.shape[-1]

        def body(tabs, j):
            return col_update(tabs, j, d, c), None

        tabs, _ = jax.lax.scan(body, init_tabs(B),
                               jnp.arange(1, Lp + 1))
        return tabs

    def tables(d: DiffFactors, c: ConstFactors):
        # strip the front padding: row j at index j (dp_max layout)
        return tuple(T[PAD:] for T in _forward(d, c))

    state_r = jnp.asarray(g.state_r)
    state_l = jnp.asarray(g.state_l)

    def marks(d: DiffFactors, c: ConstFactors):
        """Viterbi path via max-semiring cotangents.

        The reverse scan re-runs each column under ``jax.vjp`` seeded
        with 1.0 at the chosen end state; max-reduction VJPs route the
        cotangent along the argmax chain, so the cotangents of the
        injected aux transition factors mark exactly the transitions of
        the optimal alignment and the alphaP cotangents mark its paired
        spans (replacing the table fetch + host argmax re-derivation of
        scan/cyk.traceback — motif_scanner.hpp:262-362).  Exact FP
        ties split the mark mass (JAX balances equal maxima), which the
        per-read ``ok`` flag detects; such reads fall back to the host
        traceback.  Returns dict(psihat [Lp,B] int32, pairs
        [Lp+1,Wp+1,B] bool, ok [B] bool, score [B]).
        """
        assert dims.with_aux, "marks needs the aux pin factors"
        B = c.wsp.shape[-1]
        if dtype == jnp.float32:
            # f32 tie-breaker: trained models routinely have structure
            # optima degenerate at f32 resolution (helix slippage,
            # marginal lone pairs — measured 60/64 tRNA reads), which
            # splits the pair marks 50/50.  A deterministic per-cell
            # jitter on the pair injection, larger than accumulated f32
            # rounding (~1e-3 at path scale) but far below any real
            # energy quantum, resolves each degeneracy to one valid
            # optimum.  f64 (the golden-test dtype) stays exact.
            rngH = np.random.RandomState(987654321)
            H = jnp.asarray(rngH.uniform(-1.0, 1.0, (Lp + 1, Wp + 1)),
                            dtype)
            d = d._replace(alphaP=d.alphaP + 3e-3 * H[:, :, None])
            # chain-assignment ties (which motif state emits which
            # base) are broken the same way through the aux transition
            # factors — near-flat thetas (early training, all-dot
            # motifs) otherwise tie entire alignment families
            HT = {k: jnp.asarray(
                rngH.uniform(-1.0, 1.0, (Lp, S, S)), dtype)[..., None]
                for k in ("auxR", "auxL", "auxPL", "auxPR")}
            d = d._replace(
                auxR=d.auxR + 1e-3 * HT["auxR"],
                auxL=d.auxL + 1e-3 * HT["auxL"],
                auxPL=d.auxPL + 1e-3 * HT["auxPL"],
                auxPR=d.auxPR + 1e-3 * HT["auxPR"])
        tabs = _forward(d, c)
        Ot = tabs[-1]
        # end-state choice (motif_scanner.hpp:176-183): sB iff sA < sB
        OL = jnp.take_along_axis(
            Ot, jnp.broadcast_to((c.L + PAD)[None, None, :],
                                 (1, S, B)), axis=0)[0]   # [S, B]
        sA, sB = end_states[1], end_states[2]
        s0 = jnp.where(OL[sA] < OL[sB], sB, sA)           # [B]
        score = jnp.where(OL[sA] < OL[sB], OL[sB], OL[sA])
        ge = (jnp.arange(S)[:, None] == s0[None, :]).astype(dtype)

        zc = jnp.zeros((Wp + 1, S, B), dtype)

        def zwin():
            return dict(
                L=jnp.zeros((Wp, Wp + 1, S, B), dtype),
                P=jnp.zeros((Cp, Wp + 1, S, B), dtype),
                T1=jnp.zeros((Wp, Wp + 1, S, B), dtype),
                E=zc, T2=zc,
                O=jnp.zeros((Wp, S, B), dtype),
            )

        def unshift(u):
            return jnp.concatenate(
                [u[1:], jnp.zeros_like(u[:1])], axis=0)

        def body(u_win, j):
            wins_prev = windows_of(tabs, j)
            rows_j = col_rows(d, j)
            _, vjp_fn = jax.vjp(
                lambda w, r: cols_fn(w, j, r, d, c), wins_prev, rows_j)
            u_cols = dict(
                L=u_win["L"][0], P=u_win["P"][0], T1=u_win["T1"][0],
                E=u_win["E"], T2=u_win["T2"],
                M=zc, B=zc,
                O=u_win["O"][0] + ge * (c.L == j)[None, :])
            dw, dr = vjp_fn(u_cols)
            u_next = dict(
                L=unshift(u_win["L"]) + dw["L"],
                P=unshift(u_win["P"]) + dw["P"],
                T1=unshift(u_win["T1"]) + dw["T1"],
                E=dw["E"], T2=dw["T2"],
                O=unshift(u_win["O"]) + dw["O"],
            )
            # reduce over the non-rendered state axis BEFORE stacking:
            # R-kind marks render state_r[target] (sum out source),
            # L-kind state_l[source] (sum out target).  Stacking the
            # raw [w, S, S, B] rows over all columns cost 2 x 14.6 GB
            # of HLO temp at S=78 ('..........') — the sums are all
            # the decode needs.
            ys = dict(alphaP=dr["alphaP"],
                      mR=(dr["auxR"] + dr["auxPR"]).sum(axis=1),
                      mL=(dr["auxL"] + dr["auxPL"]).sum(axis=1))
            return u_next, ys

        _, ys = jax.lax.scan(body, zwin(), jnp.arange(Lp, 0, -1))
        asc = jax.tree.map(lambda y: y[::-1], ys)    # rows j = 1..Lp

        # emission marks per base p: R-kind at p = j-1 (bijective),
        # L-kind at p = clip(j - w) (scatter-add over the static map)
        iw_mat = jnp.asarray(np.clip(
            np.arange(1, Lp + 1)[:, None] - np.arange(Wp + 1)[None, :],
            0, Lp - 1))
        psR = asc["mR"]                              # [Lp, t, B]
        psL = jnp.zeros((Lp, S, B), dtype)
        psL = psL.at[iw_mat].add(asc["mL"])          # [Lp, s, B]
        # project transition marks to the OUTPUT node: R-kind emissions
        # render state_r[target], L-kind state_l[source].  Equal-score
        # alignments that differ only in which chain emits a base (the
        # systematic multiloop-gap ambiguity: M-chain vs 2-chain, both
        # node 0) merge here, so mark-mass splitting flags a read only
        # when the RENDERED path is actually ambiguous.
        M_nodes = int(max(g.state_r.max(), g.state_l.max())) + 1
        hot_r = jnp.asarray(np.eye(M_nodes)[g.state_r], dtype)  # [S, M]
        hot_l = jnp.asarray(np.eye(M_nodes)[g.state_l], dtype)
        outN = jnp.einsum("ptb,tm->pmb", psR, hot_r) \
            + jnp.einsum("psb,sm->pmb", psL, hot_l)  # [Lp, M, B]
        psihat = jnp.argmax(outN, axis=1)            # [Lp, B] node ids
        tot = outN.sum(axis=1)                       # [Lp, B]
        node_mass = outN.max(axis=1)
        # alphaP marks: pairs on the path (row 0 of alphaP is unread)
        ap = jnp.concatenate(
            [jnp.zeros((1, Wp + 1, B), dtype), asc["alphaP"]], axis=0)
        pairs = ap > 0.5

        inb = jnp.arange(Lp)[:, None] < c.L[None, :]
        dev_mass = jnp.where(inb, jnp.abs(tot - 1.0), 0.0).max(axis=0)
        dev_node = jnp.where(inb, tot - node_mass, 0.0).max(axis=0)
        ap_res = jnp.minimum(jnp.abs(ap), jnp.abs(ap - 1.0))
        dev_pair = ap_res.max(axis=(0, 1))
        ok = (dev_mass < 1e-3) & (dev_node < 1e-3) & (dev_pair < 1e-3) \
            & jnp.isfinite(score)
        return dict(psihat=psihat, pairs=pairs, ok=ok, score=score,
                    dev_mass=dev_mass, dev_node=dev_node,
                    dev_pair=dev_pair)

    return tables, marks
