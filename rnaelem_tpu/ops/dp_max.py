"""Joint (energy x motif) banded inside-outside DP, per read.

The reference implements one templated recursion consumed by five functor
families (energy_model.hpp:340-547, motif_model.hpp:230-613,
motif_trainer.hpp:274-458).  Here the same recursion is a single
``lax.scan`` over sequence columns j with all cell updates vectorized over
the band (w), motif states (S) and batch.

Gradients (the reference's entire OutsideFun/expected-count machinery,
motif_trainer.hpp:330-458) come from a custom VJP: because every column
update is a pure overwrite of row j, the pre-column state is
reconstructible from the *final* inside tables (reset row j to its
boundary value), so the backward pass is a reverse scan that re-runs each
column update under ``jax.vjp`` and accumulates cotangents — i.e. the
outside recursion, derived mechanically, with O(1) extra memory instead of
O(L) saved carries.  Expected emission counts, lambda gradients and all
scanner posteriors are then plain ``jax.grad`` through the factor tensors.

Cell conventions (span (i, j), i = j - w, bases i..j-1):
  LL: ST_L linear runs inside loops;   P: paired span (i, j-1);
  E:  interior of pair (i-1, j);       M/B/S1/S2: multiloop states;
  O:  exterior prefix [0, j).
Within a column the update order L, P, 2, B, 1, M, E, O only reads
finalized values (derived from the i-descending sequential order of
energy_model.hpp:340-441).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .semiring import NEG, lse, logadd, lam_mul, mask_neg, seg_lse
from . import ep_fast as EPF


class Dims(NamedTuple):
    Lp: int      # padded sequence length
    Wp: int      # padded band width
    Cp: int      # padded internal-loop width
    S: int
    QC: int      # quadruple chunk size
    no_ene: bool
    fix_rss: bool
    with_aux: bool


class DiffFactors(NamedTuple):
    """Differentiable log-space factor tensors (theta/lambda flow here)."""
    eR: jnp.ndarray      # [Lp, S] right emission + ws (+tau in TR)
    eL: jnp.ndarray      # [Lp, S] left emission + ws, keyed by source
    bg2: jnp.ndarray     # [Lp] background single emission
    pv: jnp.ndarray      # [Lp+1, Wp+1, Tp] pair-table emissions
    lam: jnp.ndarray     # [2] lambda buckets
    alphaP: jnp.ndarray = None  # [Lp+1, Wp+1] injected P-cell log factor
    #   (zero; its gradient is the pair posterior — used for BPP)
    auxR: Optional[jnp.ndarray] = None   # [Lp, S, S]
    auxL: Optional[jnp.ndarray] = None
    auxPL: Optional[jnp.ndarray] = None
    auxPR: Optional[jnp.ndarray] = None


class ConstFactors(NamedTuple):
    """Non-differentiable per-sequence tensors (energies, masks, gates)."""
    wsp: jnp.ndarray     # [Lp] positional weight at '('/')' nodes
    TR: jnp.ndarray      # [S,S] right transitions (incl tau), log
    TL: jnp.ndarray      # [S,S] left transitions
    TPm: jnp.ndarray     # [S,S] pair transition tau part (log, 0/-inf/tau)
    hp: jnp.ndarray      # [Lp+1, Wp+1]
    stk: jnp.ndarray
    ext: jnp.ndarray
    ml2: jnp.ndarray
    mlE: jnp.ndarray
    okP: jnp.ndarray     # [Lp+1, Wp+1] bool
    okE: jnp.ndarray
    okM: jnp.ndarray
    okB: jnp.ndarray
    gate_O2: jnp.ndarray  # [Lp] 0/-inf fix-rss gate for O_O / 2_2
    gate_M: jnp.ndarray   # [Lp]
    seq: jnp.ndarray      # [Lp] int codes
    C: jnp.ndarray        # scalar max internal loop width
    L: jnp.ndarray        # scalar true length
    dots_cum: jnp.ndarray  # [Lp+1]
    ep: dict              # factorized internal-loop tables (ep_fast)


def make_consts(g):
    """Static numpy constants derived from a compiled Grammar."""
    dense_tab = np.maximum(g.pair_table_index[g.pt_tab], 0)
    return dict(
        diag=g.diag_mask, loop=g.loop_mask, bucket=g.lam_bucket,
        pt=g.pt, pt_isbp=g.pt_isbp, pt_tabd=dense_tab,
        pt_wl=g.pt_wl, pt_wr=g.pt_wr,
        op=g.op_tuples, b12=g.b12_tuples, ep=g.ep_tuples,
        end=g.end_states,
    )


def _pad_tuples(t: np.ndarray, chunk: int):
    n = max(t.shape[0], 1)
    npad = (-n) % chunk
    tp = np.concatenate(
        [t, np.zeros((npad + n - t.shape[0], t.shape[1]), t.dtype)], 0)
    mask = np.concatenate(
        [np.zeros(t.shape[0]), np.full(tp.shape[0] - t.shape[0], -np.inf)])
    return tp, mask


def _shift_w(A, k: int):
    """src[w] = A[w-k] along the leading (band) axis, -inf filled."""
    pad = jnp.full((k,) + A.shape[1:], NEG, A.dtype)
    return jnp.concatenate([pad, A[:-k]], axis=0)


def _flip_rows(T, j, nrows: int):
    """F[r] = T[j - r] for r = 0..nrows-1 (pad + slice + flip)."""
    pad = jnp.full((nrows,) + T.shape[1:], NEG, T.dtype)
    Tp = jnp.concatenate([pad, T], axis=0)
    blk = jax.lax.dynamic_slice_in_dim(Tp, j + 1, nrows, axis=0)
    return blk[::-1]


def _mchain_assoc(Tmats, bvecs):
    """Solve x_w = (T_w o x_{w-1}) ⊕ b_w in the log semiring with x_-1
    = -inf, via an associative scan of affine maps in exp space with
    per-element shifts (matmuls instead of a 51-step sequential inner
    loop).  Returns x [W+1, S].

    Tmats: [W+1, S, S] log transition factors (target, source);
    bvecs:  [W+1, S] log source terms.
    """
    dtype = Tmats.dtype
    tiny = jnp.finfo(dtype).tiny

    msh = jax.lax.stop_gradient(jnp.max(Tmats, axis=(-2, -1)))
    msh = jnp.where(jnp.isfinite(msh), msh, 0.0)
    E = jnp.exp(Tmats - msh[:, None, None])
    vsh = jax.lax.stop_gradient(jnp.max(bvecs, axis=-1))
    vsh = jnp.where(jnp.isfinite(vsh), vsh, 0.0)
    ev = jnp.exp(bvecs - vsh[:, None])

    def combine(a, b):
        Ea, sha, eva, vsha = a
        Eb, shb, evb, vshb = b
        Ec = jnp.einsum("...ij,...jk->...ik", Eb, Ea,
                        preferred_element_type=dtype)
        shc = sha + shb
        m = jax.lax.stop_gradient(jnp.max(Ec, axis=(-2, -1)))
        m = jnp.where(m > 0, m, 1.0)
        Ec = Ec / m[..., None, None]
        shc = shc + jnp.log(m)
        # v_c = b_b ⊕ (T_b o v_a)
        tv = jnp.einsum("...ij,...j->...i", Eb, eva,
                        preferred_element_type=dtype)
        base = jnp.maximum(vshb, shb + vsha)
        base = jnp.where(jnp.isfinite(base), base, 0.0)
        evc = evb * jnp.exp(vshb - base)[..., None] \
            + tv * jnp.exp(shb + vsha - base)[..., None]
        mv = jax.lax.stop_gradient(jnp.max(evc, axis=-1))
        mv = jnp.where(mv > 0, mv, 1.0)
        evc = evc / mv[..., None]
        vshc = base + jnp.log(mv)
        return (Ec, shc, evc, vshc)

    Ec, shc, evc, vshc = jax.lax.associative_scan(
        combine, (E, msh, ev, vsh), axis=0)
    return jnp.where(evc > 0, vshc[:, None]
                     + jnp.log(jnp.maximum(evc, tiny)), NEG)


def _zero_cotangent(x):
    """Zero cotangent with the dtype JAX expects (float0 for ints/bools)."""
    if jnp.issubdtype(x.dtype, jnp.inexact):
        return jnp.zeros_like(x)
    return np.zeros(x.shape, jax.dtypes.float0)


def build_dp(g, dims: Dims, energy_tab, dtype=jnp.float64,
             semiring: str = "sum"):
    """Build (dp_parts, inside_tables) for one compiled grammar + dims.

    dp_parts(diff, const) -> [3] log partition parts at inside_o(L, s) for
    end states (0,0), (0,M-2), (0,M-1) (motif_trainer.hpp:108-112).
    inside_tables(diff, const) -> full inside tables
    (LL, P, E, M, B, T1, T2, O).

    semiring="max" turns the same recursion into the Viterbi/CYK DP
    (motif_scanner.hpp:802-913); tracebacks recompute per-cell argmaxes
    on the host from the returned tables (scan/cyk.py).
    """
    dtype = jnp.zeros((), dtype).dtype
    if semiring == "max":
        _lse = lambda x, axis=-1: jnp.max(x, axis=axis)
        _logadd = jnp.maximum
        _seg = lambda v, s, n: jax.ops.segment_max(v, s, num_segments=n)
    else:
        _lse, _logadd, _seg = lse, logadd, seg_lse
    gc = make_consts(g)
    Lp, Wp, Cp, S = dims.Lp, dims.Wp, dims.Cp, dims.S
    QC = min(dims.QC, max(1, len(gc["ep"])))

    diag = jnp.asarray(gc["diag"])
    loopm = jnp.asarray(gc["loop"])
    bucket = jnp.asarray(gc["bucket"])
    pt_mask = jnp.asarray(gc["pt"])
    pt_isbp = jnp.asarray(gc["pt_isbp"])
    pt_tabd = jnp.asarray(gc["pt_tabd"])
    pt_wl = jnp.asarray(gc["pt_wl"])
    pt_wr = jnp.asarray(gc["pt_wr"])
    op_s, op_s1, op_s2 = (jnp.asarray(gc["op"][:, k]) for k in range(3))
    b12_s, b12_s1, b12_s2 = (jnp.asarray(gc["b12"][:, k]) for k in range(3))
    ep_pad, ep_qmask_np = _pad_tuples(gc["ep"], QC)
    ep_s = jnp.asarray(ep_pad[:, 0])
    ep_s1 = jnp.asarray(ep_pad[:, 1])
    ep_s2 = jnp.asarray(ep_pad[:, 2])
    ep_s3 = jnp.asarray(ep_pad[:, 3])
    ep_qmask = jnp.asarray(ep_qmask_np, dtype)
    NQCH = len(ep_pad) // QC
    end_states = jnp.asarray(gc["end"])

    warr = jnp.arange(Wp + 1)
    dlarr = jnp.arange(Cp + 1)
    diag_col = jnp.where(diag, 0.0, NEG).astype(dtype)

    energy_np = {k: np.asarray(v) for k, v in energy_tab.items()
                 if k in ("internal", "ninio", "bulge")}
    ep_static = EPF.build_ep_static(g, Cp, energy_np, dims.no_ene)
    if semiring == "sum":
        ep_term_fast = EPF.make_ep_term(g, dims, energy_tab, ep_static,
                                        dtype)
    else:
        ep_term_fast = None
    # factorized internal-loop reconstruction (max path): class size
    # matrices [n_cls, u1, u2] + static (w, dk, dl) geometry; replaces
    # the per-column iloop_scores, whose 6-D energy-table gathers
    # dominated the vmapped CYK kernel.
    SZ_cls = jnp.asarray(ep_static.SZ, dtype)        # [n_cls, u1, u2]
    grp_cls = ep_static.grp
    _w3 = np.arange(Wp + 1)[:, None, None]
    _dk3 = np.arange(Cp + 1)[None, :, None]
    _dl3 = np.arange(Cp + 1)[None, None, :]
    _vc3 = np.clip(_w3 - _dk3 - _dl3, 0, Wp)
    # flat index into mB[g].reshape(-1) ([Cp+1, Wp+1] row-major):
    # row dl, column v = clip(w - dk - dl)
    _mb_flat_idx = jnp.asarray(
        np.broadcast_to(_dl3, _vc3.shape) * (Wp + 1) + _vc3)
    _geom_ok = jnp.asarray((_dk3 + _dl3 >= 1) & (_w3 - _dk3 - _dl3 >= 0))
    _usum3 = jnp.asarray((_dk3 + _dl3) + 0 * _w3)
    # the six base-coupled specials' (dk, dl) slots (ep_fast seq_tables
    # row order)
    _SPECS = ((0, 1), (1, 0), (1, 1), (1, 2), (2, 1), (2, 2))

    def il_factorized(c: ConstFactors, j):
        """il[w, dk, dl] == energy.tables.iloop_scores(...) from the
        precomputed per-sequence mismatch/au tables (c.ep) — no energy-
        table gathers (crosschecked in tests/test_kernel_crosscheck)."""
        ept = c.ep
        mA = jax.lax.dynamic_index_in_dim(
            ept["misA"], j, axis=1, keepdims=False)       # [4, w]
        mBblk = _flip_rows(ept["misB"].transpose(1, 0, 2), j, Cp + 1)
        mB = mBblk.transpose(1, 0, 2)                     # [4, dl, v]
        spec6 = jax.lax.dynamic_index_in_dim(
            ept["spec_il"], j, axis=1, keepdims=False)    # [6, w]
        valid = _geom_ok & (_usum3 <= c.C) & (warr[:, None, None] <= j)
        if dims.fix_rss:
            dcum = c.dots_cum
            i3 = j - warr[:, None, None]
            ld = (dcum[jnp.clip(i3 + _dk3, 0, Lp)]
                  - dcum[jnp.clip(i3, 0, Lp)]) == _dk3
            rd = (dcum[j] - dcum[jnp.clip(j - dlarr, 0, Lp)]) == dlarr
            valid = valid & ld & rd[None, None, :]
        # mBv[g][w, dk, dl] = mB[g][dl, w - dk - dl] via ONE static
        # flat-index gather per mismatch group (indices precomputed)
        il = jnp.full((Wp + 1, Cp + 1, Cp + 1), NEG, dtype)
        mBg_cache = {}
        for x in range(ep_static.SZ.shape[0]):
            gx = int(grp_cls[x])
            if gx not in mBg_cache:
                mBg_cache[gx] = mB[gx].reshape(-1)[_mb_flat_idx]
            t = SZ_cls[x][None] + mA[gx][:, None, None] + mBg_cache[gx]
            il = jnp.maximum(il, t)
        if not dims.no_ene:
            for ci, (dk0, dl0) in enumerate(_SPECS):
                il = il.at[:, dk0, dl0].set(spec6[ci])
        return jnp.where(valid, il, NEG)

    def aux_row(aux, p):
        return aux[jnp.clip(p, 0, Lp - 1)]

    def pem_col(d: DiffFactors, c: ConstFactors, j, i_of_w):
        """Pair emission tensor [Wp+1, S, S] for column j
        (profile_hmm.hpp:113-135 via motif_model.hpp:271-299)."""
        bgl = d.bg2[jnp.clip(i_of_w, 0, Lp - 1)]
        bgr = d.bg2[jnp.clip(j - 1, 0, Lp - 1)]
        bg_part = (bgl + bgr)[:, None, None]
        pvj = d.pv[j]                           # [Wp+1, Tp]
        bp_part = pvj[:, pt_tabd]               # [Wp+1, S, S]
        wl = c.wsp[jnp.clip(i_of_w, 0, Lp - 1)][:, None, None]
        wr = c.wsp[jnp.clip(j - 1, 0, Lp - 1)]
        bp_part = bp_part + jnp.where(pt_wl, wl, 0.0) \
            + jnp.where(pt_wr, wr, 0.0)
        pem = jnp.where(pt_isbp, bp_part, bg_part)
        pem = jnp.where(pt_mask, pem + c.TPm, NEG)
        if dims.with_aux:
            pem = pem + aux_row(d.auxPL, i_of_w) + d.auxPR[
                jnp.clip(j - 1, 0, Lp - 1)]
        return pem

    def col_update(tabs, j, d: DiffFactors, c: ConstFactors):
        LLt, Pt, Et, Mt, Bt, T1t, T2t, Ot = tabs
        i_of_w = j - warr
        lamv = d.lam[bucket]                    # [S]
        eRrow = d.eR[jnp.clip(j - 1, 0, Lp - 1)]
        aR = aux_row(d.auxR, j - 1) if dims.with_aux else None
        g_o2 = c.gate_O2[jnp.clip(j - 1, 0, Lp - 1)]

        prevL, prevP, prevE, prev2 = (LLt[j - 1], Pt[j - 1], Et[j - 1],
                                      T2t[j - 1])
        prevO = Ot[j - 1]

        def chain(src):
            t = src[:, None, :] + c.TR[None, :, :]
            if aR is not None:
                t = t + aR[None, :, :]
            return _lse(t, axis=-1) + eRrow[None, :]

        # U1: ST_L chain (motif_model.hpp:243-257)
        Lcol = chain(_shift_w(prevL, 1))
        Lcol = Lcol.at[0].set(diag_col)
        LLt = LLt.at[j].set(Lcol)

        # U2: P (TT_P_E / TT_P_P)
        pem = pem_col(d, c, j, i_of_w)
        a_pe = _lse(pem + _shift_w(prevE, 2)[:, None, :], axis=-1)
        a_pp = _lse(pem + _shift_w(prevP, 2)[:, None, :], axis=-1)
        Pcol = _logadd(a_pe, a_pp + lam_mul(lamv[None, :],
                                           c.stk[j][:, None]))
        Pcol = Pcol + d.alphaP[j][:, None]
        Pcol = mask_neg(Pcol, c.okP[j][:, None])
        Pt = Pt.at[j].set(Pcol)

        # U3: 2 (TT_2_2 / TT_2_P)
        T2col = _logadd(chain(_shift_w(prev2, 1)) + g_o2,
                       Pcol + lam_mul(lamv[None, :], c.ml2[j][:, None]))
        T2col = mask_neg(T2col, c.okB[j][:, None])
        T2t = T2t.at[j].set(T2col)

        # U4: B (TT_B_12): B(i,j) = sum_k 1(i,k) * 2(k,j)
        # X1[w, dk] = T1[j-(w-dk), dk]: flip block + static-index shear
        T1F = _flip_rows(T1t, j, Wp + 1)        # [m, dk, S]
        mw_idx = jnp.clip(warr[:, None, None] - warr[None, :, None],
                          0, Wp)                # [w, dk, 1]
        X1 = jnp.take_along_axis(T1F, mw_idx, axis=0)  # [w, dk, S]
        dk_ok = (warr[None, :] >= 1) & (warr[None, :] <= warr[:, None] - 1)
        X2 = T2col[jnp.clip(warr[:, None] - warr[None, :], 0, Wp)]
        Y = X1[:, :, b12_s1] + X2[:, :, b12_s2]
        Y = jnp.where(dk_ok[:, :, None], Y, NEG)
        Bcol = _seg(_lse(Y, axis=1).T, b12_s, S).T
        Bcol = mask_neg(Bcol, c.okB[j][:, None])
        Bt = Bt.at[j].set(Bcol)

        # U5: 1 (TT_1_2 / TT_1_B)
        T1col = mask_neg(_logadd(T2col, Bcol), c.okB[j][:, None])
        T1t = T1t.at[j].set(T1col)

        # U6: M chain (TT_M_M / TT_M_B): sequential affine recurrence
        # with the shared transition matrix (vector-only traffic per
        # step; motif_model.hpp:346-366)
        iw = jnp.clip(j - warr, 0, Lp - 1)
        eLrows = d.eL[iw]                        # [w, S] source-indexed
        gMs = c.gate_M[iw]
        bvecs = mask_neg(Bcol, c.okM[j][:, None])
        okMj = c.okM[j]
        auxLrows = d.auxL[iw] if dims.with_aux else None

        def m_step(x, blk):
            if dims.with_aux:
                eb, gb, bb, ob, ab = blk
                t = x[None, :] + c.TL + eb[None, :] + gb + ab
            else:
                eb, gb, bb, ob = blk
                t = x[None, :] + c.TL + eb[None, :] + gb
            cur = mask_neg(_logadd(bb, _lse(t, axis=-1)), ob)
            return cur, cur

        xs = (eLrows, gMs, bvecs, okMj) if not dims.with_aux else \
            (eLrows, gMs, bvecs, okMj, auxLrows)
        _, Mcol = jax.lax.scan(m_step, jnp.full((S,), NEG, dtype), xs)
        Mt = Mt.at[j].set(Mcol)

        # U7: E (TT_E_H / TT_E_M / TT_E_P)
        hterm = jnp.where(loopm[None, :],
                          Lcol + lam_mul(lamv[None, :], c.hp[j][:, None]),
                          NEG)
        mterm = Mcol + lam_mul(lamv[None, :], c.mlE[j][:, None])

        if ep_term_fast is not None:
            ep_term = ep_term_fast(d, c, j, Pt, LLt, Lcol)
        else:
            il = il_factorized(c, j)
            PK = Pt[jnp.clip(j - dlarr, 0, Lp)]      # [dl, v, S]
            rows_ik = jnp.clip(j - warr[:, None] + dlarr[None, :], 0, Lp)
            LLik = LLt[rows_ik, dlarr[None, :], :]   # [w, dk, S]
            LLr = Lcol[: Cp + 1]                     # [dl, S]
            v = warr[:, None, None] - dlarr[None, :, None] \
                - dlarr[None, None, :]
            vc = jnp.clip(v, 0, Wp)

            def ep_chunk(cidx, acc):
                q_s = jax.lax.dynamic_slice(ep_s, (cidx * QC,), (QC,))
                q_s1 = jax.lax.dynamic_slice(ep_s1, (cidx * QC,), (QC,))
                q_s2 = jax.lax.dynamic_slice(ep_s2, (cidx * QC,), (QC,))
                q_s3 = jax.lax.dynamic_slice(ep_s3, (cidx * QC,), (QC,))
                q_m = jax.lax.dynamic_slice(ep_qmask, (cidx * QC,), (QC,))
                lamq = d.lam[bucket[q_s]]
                pk = PK[dlarr[None, None, :, None], vc[..., None],
                        q_s1[None, None, None, :]]   # [w, dk, dl, QC]
                ll2 = LLik[:, :, None, q_s2]         # [w, dk, 1, QC]
                ll3 = LLr[None, None, :, q_s3]       # [1, 1, dl, QC]
                ilq = lam_mul(lamq[None, None, None, :], il[..., None])
                term = pk + ll2 + ll3 + ilq + q_m
                red = _lse(term.reshape(Wp + 1, -1, QC), axis=1)
                return _logadd(acc, _seg(red.T, q_s, S).T)

            ep_term = jax.lax.fori_loop(
                0, NQCH, ep_chunk, jnp.full((Wp + 1, S), NEG, dtype))
        Ecol = _logadd(_logadd(hterm, mterm), ep_term)
        Ecol = mask_neg(Ecol, c.okE[j][:, None])
        Et = Et.at[j].set(Ecol)

        # U8: O (TT_O_O / TT_O_OP)
        t = prevO[None, :] + c.TR
        if aR is not None:
            t = t + aR
        oo = _lse(t, axis=-1) + eRrow + g_o2
        Orows = _flip_rows(Ot, j, Wp + 1)            # [w', S]
        base = Orows[:, None, :] + Pcol[:, :, None]  # [w', s1, s2]
        D = jnp.stack([
            _lse(base + lam_mul(d.lam[b], c.ext[j])[:, None, None], axis=0)
            for b in range(2)])                      # [2, S, S]
        op_term = _seg(D[bucket[op_s], op_s1, op_s2], op_s, S)
        Ocol = _logadd(oo, op_term)
        Ot = Ot.at[j].set(Ocol)

        return (LLt, Pt, Et, Mt, Bt, T1t, T2t, Ot)

    def init_tabs():
        z3 = jnp.full((Lp + 1, Wp + 1, S), NEG, dtype)
        LLt = z3.at[:, 0, :].set(diag_col)
        Ot = jnp.full((Lp + 1, S), NEG, dtype)
        Ot = Ot.at[0].set(
            jnp.where(jnp.arange(S) == end_states[0], 0.0, NEG)
            .astype(dtype))
        return (LLt, z3, z3, z3, z3, z3, z3, Ot)

    def inside_tables(d: DiffFactors, c: ConstFactors):
        def body(tabs, j):
            return col_update(tabs, j, d, c), None
        tabs, _ = jax.lax.scan(body, init_tabs(), jnp.arange(1, Lp + 1))
        return tabs

    @jax.custom_vjp
    def dp_parts(d: DiffFactors, c: ConstFactors):
        tabs = inside_tables(d, c)
        return tabs[-1][c.L][end_states]

    def dp_fwd(d, c):
        tabs = inside_tables(d, c)
        return tabs[-1][c.L][end_states], (d, c, tabs)

    def dp_bwd(res, gbar):
        d, c, tabs = res
        u_tabs = jax.tree.map(jnp.zeros_like, tabs)
        uO = u_tabs[-1].at[c.L, end_states].add(gbar)
        u_tabs = u_tabs[:-1] + (uO,)
        d_zero = jax.tree.map(jnp.zeros_like, d)

        # The pre-column table state need not be reconstructed: within
        # col_update, every read of a row >= j either happens after that
        # row was functionally overwritten this column (so the vjp routes
        # its cotangent into the freshly computed column, not the input)
        # or is provably masked to -inf (O row j via the w'=0 exterior
        # split, gated by okP).  Passing the final tables therefore
        # reproduces the forward values exactly and jax.vjp of the column
        # update *is* the outside recursion.
        def body(carry, j):
            u_t, d_acc = carry
            _, vjp_fn = jax.vjp(
                lambda tb, dd: col_update(tb, j, dd, c), tabs, d)
            du_tabs, dd = vjp_fn(u_t)
            d_acc = jax.tree.map(jnp.add, d_acc, dd)
            return (du_tabs, d_acc), None

        (_, d_acc), _ = jax.lax.scan(
            body, (u_tabs, d_zero), jnp.arange(Lp, 0, -1))
        c_zero = jax.tree.map(_zero_cotangent, c)
        return d_acc, c_zero

    dp_parts.defvjp(dp_fwd, dp_bwd)
    return dp_parts, inside_tables
