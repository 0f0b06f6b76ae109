"""Joint (energy x motif) banded inside-outside DP — batched.

One ``lax.scan`` over sequence columns j computes the inside recursion of
the reference (energy_model.hpp:340-441 fanned out over motif states by
motif_model.hpp:230-423) for a WHOLE BATCH of reads at once, sum semiring
only (the max/CYK twin lives in ops/dp_max.py).

Design decisions (vs the per-read column scan of round 1):

* **Batch-minor layout**: every tensor carries the batch axis LAST, so
  the minor dimension is the batch rather than the small (W+1) x S =
  51 x 29 band-by-state plane of a vmap'd per-read kernel.
* **Exp-space matmuls**: all state fan-outs (right-chain transitions,
  pair transitions, B=1x2 bifurcation splits, O=O*P exterior splits and
  the TT_E_P quadruple sum) are computed as max-shifted exponential
  matmuls against static 0/1 (or tau) matrices — dense products instead
  of logsumexp reductions.  Shifts are jax.lax.stop_gradient'd so
  reverse-mode gradients stay exact.  Their float32 accuracy depends on
  jax_default_matmul_precision (rnaelem_tpu/runtime.py).
  Whether this layout is the fast one on a GPU has not been measured.
* **Hoisted energy exponentials**: exp(lambda * {misA, misB, SZ, ext})
  are computed once per evaluation outside the column scan (the round-1
  kernel re-exponentiated the internal-loop tensors per column per
  class per lambda bucket — the measured hotspot, 2/3 of forward time).
* **No full-table concatenates**: DP tables are allocated with Wp+1
  padding rows of -inf in front, so band reads are fused dynamic slices
  instead of pad+concat copies of the whole table.

Gradients (the reference's OutsideFun/expected-count machinery,
motif_trainer.hpp:330-458) come from a custom VJP: the column body is a
pure function of a sliding WINDOW of previous rows (cols_fn), so the
reverse scan re-runs it per column under ``jax.vjp`` and carries only
the band-depth window COTANGENTS — carrying full-table cotangents made
XLA copy ~500 MB per backward step (measured: 3x the entire eval).

Cell conventions (span (i, j), i = j - w, bases i..j-1):
  LL: ST_L linear runs inside loops;   P: paired span (i, j-1);
  E:  interior of pair (i-1, j);       M/B/T1/T2: multiloop states;
  O:  exterior prefix [0, j).
Within a column the update order L, P, 2, B, 1, M, E, O only reads
finalized values (the i-descending order of energy_model.hpp:340-441).
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

# perf-bisect hook (trace-time static): RNAELEM_ABLATE=ep,b,m,o,p,spec
_ABLATE = frozenset(
    x for x in os.environ.get("RNAELEM_ABLATE", "").split(",") if x)
# inner M-chain unroll factor: the band-deep sequential scan issues
# ~51 tiny [S, B] steps per column; unrolling lets XLA fuse runs of
# them into one kernel (experiment knob, unmeasured on the GPU)
_M_UNROLL = int(os.environ.get("RNAELEM_M_UNROLL", "1"))
# outer column-scan unroll (forward and backward)
_COL_UNROLL = int(os.environ.get("RNAELEM_COL_UNROLL", "1"))
if _ABLATE:
    import sys as _sys
    print("*** RNAELEM_ABLATE=%s: DP sub-terms are DISABLED — results "
          "are WRONG; this is a profiling bisect hook only ***"
          % ",".join(sorted(_ABLATE)), file=_sys.stderr, flush=True)

from .semiring import NEG, lse, logadd, lam_mul, mask_neg
from .ep_fast import build_ep_static


class Dims(NamedTuple):
    Lp: int      # padded sequence length
    Wp: int      # padded band width
    Cp: int      # padded internal-loop width
    S: int
    no_ene: bool
    fix_rss: bool
    with_aux: bool
    ltau: float  # log self-transition penalty (static per config)


class DiffFactors(NamedTuple):
    """Differentiable log-space factors; trailing batch axis B throughout
    (lam excepted: parameters are shared across the batch)."""
    eR: jnp.ndarray      # [Lp, S, B] right emission + ws
    eL: jnp.ndarray      # [Lp, S, B] left emission + ws, keyed by source
    bg2: jnp.ndarray     # [Lp, B] background single emission
    pv: jnp.ndarray      # [Lp+1, Wp+1, Tp, B] pair-table emissions
    lam: jnp.ndarray     # [2] shared or [2, B] per-read (per-read grads)
    alphaP: jnp.ndarray = None  # [Lp+1, Wp+1, B] injected P-cell factor
    #   (zero; its gradient is the pair posterior — used for BPP)
    auxR: Optional[jnp.ndarray] = None   # [Lp, S, S, B]
    auxL: Optional[jnp.ndarray] = None
    auxPL: Optional[jnp.ndarray] = None
    auxPR: Optional[jnp.ndarray] = None


class ConstFactors(NamedTuple):
    """Non-differentiable per-sequence tensors, trailing batch axis."""
    wsp: jnp.ndarray     # [Lp, B] positional weight at '('/')' nodes
    hp: jnp.ndarray      # [Lp+1, Wp+1, B]
    stk: jnp.ndarray
    ext: jnp.ndarray
    ml2: jnp.ndarray
    mlE: jnp.ndarray
    okP: jnp.ndarray     # [Lp+1, Wp+1, B] bool
    okE: jnp.ndarray
    okM: jnp.ndarray
    okB: jnp.ndarray
    gate_O2: jnp.ndarray  # [Lp, B] 0/-inf fix-rss gate for O_O / 2_2
    gate_M: jnp.ndarray   # [Lp, B]
    seq: jnp.ndarray      # [Lp, B] int codes
    C: jnp.ndarray        # [B] max internal loop width
    L: jnp.ndarray        # [B] true length
    dots_cum: jnp.ndarray  # [Lp+1, B]
    ep: dict              # misA/misB [4, Lp+1, Wp+1, B], t_out/t_in ints


def _shift_w(A, k: int, fill=NEG):
    """src[w] = A[w-k] along the leading (band) axis."""
    if k == 0:
        return A
    pad = jnp.full((k,) + A.shape[1:], fill, A.dtype)
    return jnp.concatenate([pad, A[:-k]], axis=0)


def _shear(A, J: int, fill):
    """Y[d, j] = A[d, j - d] (gather-free pad+reshape+slice)."""
    D, R = A.shape[0], A.shape[1]
    tail = A.shape[2:]
    K = R + max(D, J - R + 1)
    M2 = jnp.pad(A, ((0, 0), (0, K - R)) + ((0, 0),) * len(tail),
                 constant_values=fill)
    flat = M2.reshape((D * K,) + tail)
    Y = flat[: D * (K - 1)].reshape((D, K - 1) + tail)
    return Y[:, :J]


def _finmax(x, axes, keepdims=False):
    """stop-gradient max over axes with -inf replaced by 0 (shift base)."""
    m = jax.lax.stop_gradient(jnp.max(x, axis=axes, keepdims=keepdims))
    return jnp.where(jnp.isfinite(m), m, 0.0)


def _safe_log(s, dtype):
    tiny = jnp.finfo(dtype).tiny
    return jnp.where(s > 0, jnp.log(jnp.maximum(s, tiny)), NEG)


def _pem_combos(g, ltau: float):
    """Static exp-space pair-transition matrices, factored by emission
    kind (profile_hmm.hpp:113-135 via motif_model.hpp:271-299): one
    background matrix plus one matrix per (pair-table, ws-left, ws-right)
    combination actually present in the grammar."""
    tau = float(np.exp(ltau)) if np.isfinite(ltau) else 0.0
    tfac = np.where(g.pt_tau, tau, 1.0)
    mbg = np.where(g.pt & ~g.pt_isbp, tfac, 0.0)
    dense_tab = np.maximum(g.pair_table_index[g.pt_tab], 0)
    combos = []
    for t in range(max(1, g.n_pair_tables)):
        for a in (False, True):
            for b in (False, True):
                m = (g.pt & g.pt_isbp & (dense_tab == t)
                     & (g.pt_wl == a) & (g.pt_wr == b))
                if m.any():
                    combos.append((t, a, b, np.where(m, tfac, 0.0)))
    return mbg, combos


def build_dp(g, dims: Dims, energy_tab, dtype=jnp.float64):
    """Build (dp_parts, inside_tables) for one compiled grammar + dims.

    dp_parts(diff, const) -> [B, 3] log partition parts at inside_o(L, s)
    for end states (0,0), (0,M-2), (0,M-1) (motif_trainer.hpp:108-112).
    inside_tables(diff, const) -> full inside tables with Wp+1 rows of
    front padding: (LL, P, E, M, B, T1, T2, O); row j lives at j + PAD.
    """
    # canonicalize: float64 without jax_enable_x64 actually runs f32, and
    # finfo(float64) constants (BIG_NEG, tiny) would overflow to -inf
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

    # static transition matrices (target, source), exp space
    tau = float(np.exp(ltau)) if np.isfinite(ltau) else 0.0
    E_TR = jnp.asarray(
        np.where(g.rt, np.where(g.rt_tau, tau, 1.0), 0.0), dtype)
    TL = jnp.asarray(np.where(g.lt, np.where(g.lt_tau, ltau, 0.0),
                              -np.inf), dtype)

    mbg_np, combos = _pem_combos(g, ltau)
    Mbg = jnp.asarray(mbg_np, dtype)
    # pem masks needed for the dense with_aux path
    pt_mask = jnp.asarray(g.pt)
    pt_isbp = jnp.asarray(g.pt_isbp)
    pt_tabd = jnp.asarray(np.maximum(g.pair_table_index[g.pt_tab], 0))
    pt_wl = jnp.asarray(g.pt_wl)
    pt_wr = jnp.asarray(g.pt_wr)
    TPm = jnp.asarray(np.where(g.pt_tau, ltau, 0.0), dtype)

    # --- TT_E_P chain factorization (motif_model.hpp:315-335) ---
    # A quadruple (tgt, s1, s2, s3) is a path l -> a -> c -> r through
    # the node graph: s2=(l,a) left flank, s1=(a,c) inner pair,
    # s3=(c,r) right flank, tgt=(l,r).  The tuple set is EXACTLY the
    # product of its pairwise links (verified against profile_hmm
    # semantics for all pattern shapes), so the 4-state sum factors into
    # three small contractions instead of one nq-wide enumeration:
    #   pairs13: distinct (s1, s3) -> AR: distinct (a=s1.l, r=s3.r)
    #   K2:      distinct (s2, AR) -> target state
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
        p13_s1 = np.array([p[0] for p in pairs13])
        p13_s3 = np.array([p[1] for p in pairs13])
        p13_ar = np.array([ar_of[(int(l_[p[0]]), int(r_[p[1]]))]
                           for p in pairs13])
        k2_s2 = np.array([k[0] for k in k2_list])
        k2_ar = np.array([k[1] for k in k2_list])
        k2_tgt = np.array([
            int(g.n2s[l_[s2], ar_list[ai][1]])
            for s2, ai in k2_list])
        assert (k2_tgt >= 0).all()
        k2_bu = bucket_np[k2_tgt]
        eyeS = np.eye(S)
        Hot_s1_13 = jnp.asarray(eyeS[p13_s1].T, dtype)     # [S, n13]
        Hot_s3_13 = jnp.asarray(eyeS[p13_s3].T, dtype)
        Hot_13_ar = jnp.asarray(
            np.eye(n_ar)[p13_ar], dtype)                   # [n13, n_ar]
        Hot_s2_k2 = jnp.asarray(eyeS[k2_s2].T, dtype)      # [S, n2]
        Hot_ar_k2 = jnp.asarray(np.eye(n_ar)[k2_ar].T, dtype)
        Hot_arcat_k2 = jnp.asarray(
            np.eye(2 * n_ar)[k2_bu * n_ar + k2_ar].T, dtype)
        Hot_k2_tgt = jnp.asarray(eyeS[k2_tgt], dtype)      # [n2, S]
        lamk2_idx = jnp.asarray(k2_bu)
        # anti-diagonal indicator: w = x (inner span) + u1 (left gap)
        Ind_np = np.zeros((Wp + 1, Cp + 1, Wp + 1))
        for x_ in range(Wp + 1):
            for u_ in range(Cp + 1):
                if x_ + u_ <= Wp:
                    Ind_np[x_, u_, x_ + u_] = 1.0
        Ind = jnp.asarray(Ind_np, dtype)

    # B_12 splits: exp-matmul over (dk) then static tuple-sum matrix
    Hb12 = np.zeros((S * S, S))
    for (t, a, c2) in g.b12_tuples:
        Hb12[a * S + c2, t] = 1.0
    Hb12 = jnp.asarray(Hb12, dtype)

    # O_OP splits, grouped by the lambda bucket of the target state
    Hop = np.zeros((2, S * S, S))
    for (t, a, c2) in g.op_tuples:
        Hop[bucket_np[t], a * S + c2, t] = 1.0
    Hop = [jnp.asarray(Hop[b], dtype) for b in range(2)]

    # internal-loop energy size classes (shared with the CYK twin)
    energy_np = {k: np.asarray(v) for k, v in energy_tab.items()
                 if k in ("internal", "ninio", "bulge")}
    est = build_ep_static(g, Cp, energy_np, dims.no_ene)
    n_cls = est.SZ.shape[0]
    grp = est.grp
    SZ_np = est.SZ  # [n_cls, Cp+1(u1), Cp+1(u2)]
    # static eMA geometry: w = x (inner span) + u1 (left gap)
    ru = np.minimum(np.arange(Wp + 1)[:, None]
                    + np.arange(Cp + 1)[None, :], Wp)
    ru_ok = jnp.asarray((np.arange(Wp + 1)[:, None]
                         + np.arange(Cp + 1)[None, :]) <= Wp, dtype)
    ruj = jnp.asarray(ru)

    def _lam2(lam):
        """Normalize lambda to [2, 1-or-B] (per-read lambda broadcasts)."""
        return lam if lam.ndim == 2 else lam[:, None]

    def hoisted(d: DiffFactors, c: ConstFactors):
        """Per-evaluation exp-space energy tensors (lambda flows here)."""
        lam = _lam2(d.lam)                    # [2, 1 or B]
        B = c.wsp.shape[-1]
        h = {}
        # eSZ[bu][cls]: [Cp+1 (dl=u2), Cp+1 (u1), B] with the per-read
        # C-cap folded in (dl + u1 <= C)
        cmask = (dlarr[:, None, None] + dlarr[None, :, None]
                 <= c.C[None, None, :])
        h["eSZ"] = [[jnp.exp(lam_mul(
            lam[b][None, None, :],
            jnp.asarray(SZ_np[x].T, dtype)[:, :, None])) * cmask
                     for x in range(n_cls)] for b in range(2)]
        # misA/misB exps; emisB is stored rows-leading [Lp+1+PAD, v, 4, B]
        # (PAD front rows) so the per-column flip+shear needs no
        # transposes
        def padrows(x, fill):
            pad = jnp.full((PAD,) + x.shape[1:], fill, x.dtype)
            return jnp.concatenate([pad, x], axis=0)
        h["emisA"] = [jnp.exp(lam_mul(lam[b], c.ep["misA"]))
                      for b in range(2)]                  # [4, Lp+1, w, B]
        h["emisB"] = [padrows(
            jnp.exp(lam_mul(lam[b], c.ep["misB"])).transpose(1, 2, 0, 3),
            0.0) for b in range(2)]
        # exterior split weights exp(lam_b * ext[j, w'])
        h["eext"] = [jnp.exp(lam_mul(lam[b], c.ext)) for b in range(2)]
        return h

    def aux_row(aux, p):
        return aux[jnp.clip(p, 0, Lp - 1)]

    def flip(T, j, n):
        """rows j, j-1, ..., j-n+1 of a front-padded table."""
        blk = jax.lax.dynamic_slice_in_dim(T, j + PAD - n + 1, n, axis=0)
        return blk[::-1]

    def col_rows(d: DiffFactors, h, j):
        """The row slices of the differentiable inputs that column j
        actually reads.  Routing every d/h read through this dict lets
        the backward scan take cotangents of ROWS (a few hundred KB per
        column, emitted as stacked scan outputs) instead of
        accumulating cotangents of the full tensors in the carry —
        which was over half the backward wall clock (copies + adds of
        ~45 MB of mostly-zero tensors per column)."""
        i_of_w = j - warr
        iw = jnp.clip(i_of_w, 0, Lp - 1)
        jm = jnp.clip(j - 1, 0, Lp - 1)
        return dict(
            lam=d.lam,
            eR=d.eR[jm],                    # [S, B]
            eL=d.eL[iw],                    # [Wp+1, S, B]
            bgl=d.bg2[iw],                  # [Wp+1, B]
            bgr=d.bg2[jm],                  # [B]
            pv=d.pv[j],                     # [Wp+1, Tp, B]
            alphaP=d.alphaP[j],             # [Wp+1, B]
            emisA=[h["emisA"][b][:, j] for b in range(2)],  # [4, w, B]
            emisB=[flip(h["emisB"][b], j, Cp + 1)
                   for b in range(2)],      # [Cp+1, v, 4, B]
            eext=[h["eext"][b][j] for b in range(2)],       # [w, B]
            eSZ=h["eSZ"],                   # whole (small)
        )

    def chain(src, eRrow, aR):
        """Right-transition chain: [w,S,B] -> [w,S,B] target-indexed."""
        m = _finmax(src, 1, keepdims=True)              # [w,1,B]
        ex = jnp.exp(src - m)
        if aR is None:
            t = jnp.einsum("ts,wsb->wtb", E_TR, ex,
                           preferred_element_type=dtype)
        else:
            t = jnp.einsum("tsb,wsb->wtb", E_TR[:, :, None] * jnp.exp(aR),
                           ex, preferred_element_type=dtype)
        return _safe_log(t, dtype) + m + eRrow[None]

    def chain1(src, eRrow, aR, extra):
        """Single-row chain for the O table: [S,B] -> [S,B]."""
        m = _finmax(src, 0, keepdims=True)              # [1,B]
        ex = jnp.exp(src - m)
        if aR is None:
            t = jnp.einsum("ts,sb->tb", E_TR, ex,
                           preferred_element_type=dtype)
        else:
            t = jnp.einsum("tsb,sb->tb", E_TR[:, :, None] * jnp.exp(aR),
                           ex, preferred_element_type=dtype)
        return _safe_log(t, dtype) + m + eRrow + extra

    def pem_dense(rows, aux, c, j, i_of_w):
        """Dense pair-emission tensor [w,S,S,B] (with_aux scanner path)."""
        bgl = rows["bgl"]                                 # [w,B]
        bgr = rows["bgr"]                                 # [B]
        bg_part = bgl[:, None, None, :] + bgr[None, None, None, :]
        pvj = rows["pv"]                                  # [w, Tp, B]
        bp_part = pvj[:, pt_tabd, :]                      # [w, S, S, B]
        wl = c.wsp[jnp.clip(i_of_w, 0, Lp - 1)][:, None, None, :]
        wr = c.wsp[jnp.clip(j - 1, 0, Lp - 1)][None, None, None, :]
        bp_part = bp_part + jnp.where(pt_wl[None, :, :, None], wl, 0.0) \
            + jnp.where(pt_wr[None, :, :, None], wr, 0.0)
        pem = jnp.where(pt_isbp[None, :, :, None], bp_part, bg_part)
        pem = jnp.where(pt_mask[None, :, :, None],
                        pem + TPm[None, :, :, None], NEG)
        if dims.with_aux:
            pem = pem + aux_row(aux[2], i_of_w)[:, :, :, :] \
                + aux[3][jnp.clip(j - 1, 0, Lp - 1)][None]
        return pem

    def p_col(rows, aux, c, j, i_of_w, prevE2, prevP2, lamv):
        """U2: P <- pem * (E | P), factored into static-matrix matmuls."""
        if dims.with_aux:
            pem = pem_dense(rows, aux, c, j, i_of_w)
            a_pe = lse(pem + prevE2[:, None, :, :], axis=2)
            a_pp = lse(pem + prevP2[:, None, :, :], axis=2)
        else:
            wl = c.wsp[jnp.clip(i_of_w, 0, Lp - 1)]       # [w,B]
            wr = c.wsp[jnp.clip(j - 1, 0, Lp - 1)]        # [B]
            bgf = jnp.exp(rows["bgl"] + rows["bgr"][None])
            pvj = rows["pv"]                              # [w, Tp, B]
            outs = []
            for src in (prevE2, prevP2):
                m = _finmax(src, 1, keepdims=True)        # [w,1,B]
                ex = jnp.exp(src - m)
                acc = jnp.einsum("ts,wsb->wtb", Mbg, ex,
                                 preferred_element_type=dtype) \
                    * bgf[:, None, :]
                for (t, a, b2, mask) in combos:
                    fac = pvj[:, t, :]
                    if a:
                        fac = fac + wl
                    if b2:
                        fac = fac + wr
                    acc = acc + jnp.einsum(
                        "ts,wsb->wtb", jnp.asarray(mask, dtype), ex,
                        preferred_element_type=dtype) \
                        * jnp.exp(fac)[:, None, :]
                outs.append(_safe_log(acc, dtype) + m)
            a_pe, a_pp = outs
        a_pp = a_pp + lam_mul(lamv[None], c.stk[j][:, None, :])
        Pcol = logadd(a_pe, a_pp) + rows["alphaP"][:, None, :]
        return mask_neg(Pcol, c.okP[j][:, None, :])

    def b_col(c, j, T1F, T2col):
        """U4: B(i,j) = sum_k 1(i,k) * 2(k,j) as one dk-contraction
        matmul plus a static tuple-sum matmul (TT_B_12).
        T1F[dk] = T1 row j-dk (dk=0 slot is ignored)."""
        m1 = _finmax(T1F, (0, 1, 2), keepdims=False)[None, None, None, :]
        ex1 = jnp.exp(T1F - m1)
        ex1 = ex1.at[0].set(0.0)                   # dk >= 1 (k < j)
        X1 = _shear(ex1, Wp + 1, 0.0)              # [dk, w, S, B]
        m2 = _finmax(T2col, (0, 1), keepdims=False)[None, None, :]
        ex2 = jnp.exp(T2col - m2)
        ex2 = ex2.at[0].set(0.0)                   # width(2-cell) >= 1
        G = jnp.einsum("dwab,dcb->wacb", X1, ex2,
                       preferred_element_type=dtype)
        out = jnp.einsum("wqb,qt->wtb",
                         G.reshape(Wp + 1, S * S, -1), Hb12,
                         preferred_element_type=dtype)
        Bcol = _safe_log(out, dtype) + m1[0] + m2
        return mask_neg(Bcol, c.okB[j][:, None, :])

    def m_col(rows, aux, c, j, Bcol, dtype_):
        """U6: multiloop M chain, sequential over the band
        (motif_model.hpp:346-366)."""
        iw = jnp.clip(j - warr, 0, Lp - 1)
        eLrows = rows["eL"]                      # [w, S, B] source-keyed
        gMs = c.gate_M[iw]                       # [w, B]
        bvecs = mask_neg(Bcol, c.okM[j][:, None, :])
        okMj = c.okM[j]                          # [w, B]
        auxLrows = aux[1][iw] if dims.with_aux else None
        B = Bcol.shape[-1]

        def m_step(x, blk):
            if dims.with_aux:
                eb, gb, bb, ob, ab = blk
                t = x[None, :, :] + TL[:, :, None] + eb[None, :, :] \
                    + gb[None, None, :] + ab
            else:
                eb, gb, bb, ob = blk
                t = x[None, :, :] + TL[:, :, None] + eb[None, :, :] \
                    + gb[None, None, :]
            cur = mask_neg(logadd(bb, lse(t, axis=1)), ob[None, :])
            return cur, cur

        xs = (eLrows, gMs, bvecs, okMj) if not dims.with_aux else \
            (eLrows, gMs, bvecs, okMj, auxLrows)
        _, Mcol = jax.lax.scan(m_step, jnp.full((S, B), NEG, dtype_), xs,
                               unroll=_M_UNROLL)
        return Mcol

    def ep_col(rows, c, j, PF, LB, Lcol):
        """U7 TT_E_P internal-loop sum (motif_model.hpp:329-335,
        energy_param.hpp:744-795), chain-factored.

        The quadruple fan-out is computed as three small contractions
        through the chain spaces (pairs13 -> AR -> K2) instead of one
        nq-wide enumeration; the five (u1, u2) energy classes collapse
        into a single fused weight tensor W[dl, x, u1] per lambda
        bucket, and the final w = x + u1 anti-diagonal sum is one
        static-indicator matmul — intermediates stay at band x gap x
        n_ar instead of band x band x nq.  Everything is exp-space under
        stop-gradient max shifts, so reverse mode stays exact."""
        B = Lcol.shape[-1]
        if not have_ep:
            return jnp.full((Wp + 1, S, B), NEG, dtype)
        lam = _lam2(rows["lam"])
        mPF = _finmax(PF, (0, 1, 2))[None, None, None, :]
        exPF = jnp.exp(PF - mPF)
        mL3 = _finmax(Lcol[: Cp + 1], (0, 1))[None, None, :]
        exL3 = jnp.exp(Lcol[: Cp + 1] - mL3)      # [dl, S, B]
        dcum = c.dots_cum
        if dims.fix_rss:
            rd = (dcum[j] - dcum[jnp.clip(j - dlarr, 0, None)]
                  ) == dlarr[:, None]              # [dl, B]
            exL3 = exL3 * rd[:, None, :]

        # T stage: inner pair x right flank -> AR = (a, r) pairs
        tP = jnp.einsum("dvsb,sp->dvpb", exPF, Hot_s1_13,
                        preferred_element_type=dtype)
        tL = jnp.einsum("dsb,sp->dpb", exL3, Hot_s3_13,
                        preferred_element_type=dtype)
        T13 = tP * tL[:, None]                    # [dl, v, n13, B]
        T = jnp.einsum("dvpb,pa->dvab", T13, Hot_13_ar,
                       preferred_element_type=dtype)
        Tsh = _shear(T, Wp + 1, 0.0)              # [dl, x=dl+v, n_ar, B]

        # fused energy weight W[bu][dl, x, u1, B]: misB (inner pair) x
        # size/asymmetry class x misA (outer pair), classes summed.
        # misA's w = x + u1 geometry is the Ind indicator matmul
        # instead of a gather.
        mBsh = [_shear(rows["emisB"][b], Wp + 1, 0.0)
                for b in range(2)]                 # [dl, x, 4, B]
        mArow = rows["emisA"]                      # [4, w, B] per bucket
        V_bu = []
        for b in range(2):
            wA = [mArow[b][g_][ruj] * ru_ok[:, :, None]
                  for g_ in range(4)]              # [x, u1, B] per group
            Wall = None
            for x_ in range(n_cls):
                g_ = grp[x_]
                t = (mBsh[b][:, :, g_, None, :]
                     * rows["eSZ"][b][x_][:, None, :, :]
                     * wA[g_][None, :, :, :])      # [dl, x, u1, B]
                Wall = t if Wall is None else Wall + t
            # V[x, u1, ar, B] = sum_dl Tsh * Wall as a fused
            # multiply-reduce rather than a dot_general with batch dims
            # (x, B) or (B,)
            V_bu.append((Tsh[:, :, None, :, :]
                         * Wall[:, :, :, None, :]).sum(axis=0))

        # left flank LL(j-x, u1) and the K2 = (s2, AR) -> target stage
        LBc = LB[:, : Cp + 1]                     # u1 <= Cp
        mLB = _finmax(LBc, (0, 1, 2))[None, None, None, :]
        exLB = jnp.exp(LBc - mLB)
        if dims.fix_rss:
            ld = (dcum[jnp.clip(j - warr[:, None], 0, None)]
                  - dcum[jnp.clip(j - warr[:, None] - dlarr[None, :],
                                  0, None)]) == dlarr[None, :, None]
            exLB = exLB * ld[:, :, None, :]        # [x, u1, 1, B]
        pickL = jnp.einsum("xusb,sk->xukb", exLB, Hot_s2_k2,
                           preferred_element_type=dtype)
        Vcat = jnp.concatenate(V_bu, axis=2)      # [x, u1, 2*n_ar, B]
        pickV = jnp.einsum("xuab,ak->xukb", Vcat, Hot_arcat_k2,
                           preferred_element_type=dtype)
        G2 = pickL * pickV                        # [x, u1, n2, B]

        outw = jnp.einsum("xukb,xuw->wkb", G2, Ind,
                          preferred_element_type=dtype)
        # base-coupled specials share the same shifts -> add in exp space
        if not (dims.no_ene or "spec" in _ABLATE):
            outw = outw + _ep_specials(c, j, exPF, exLB, exL3, lam)
        out = jnp.einsum("wkb,kt->wtb", outw, Hot_k2_tgt,
                         preferred_element_type=dtype)
        shift = mPF[0, 0] + mL3[0] + mLB[0, 0]    # [1, B]
        return _safe_log(out, dtype) + shift

    SPEC_COMBOS = ((0, 1), (1, 0), (1, 1), (1, 2), (2, 1), (2, 2))

    def _ep_specials(c, j, exPF, exLB, exL3, lam):
        """Base-coupled internal loops — stack-adjacent bulges (0,1)/(1,0)
        and 1x1/1x2/2x1/2x2 internals (energy_param.hpp:744-795) — in the
        same chain-factored exp space; returns a [w, n2, B] contribution
        carrying the ep_col shifts (added at G2[:, u1=0]).

        The per-(j, w) base-coupled energies are precomputed once per
        read (c.ep["spec_il"], ep_fast.seq_tables), so the column body
        has no table gathers.  fix_rss flank masks ride in via
        exLB/exL3.  The six combos stay a small unrolled loop: a
        stacked single-einsum form crashed an earlier XLA backend's
        fusion emitter in reverse mode and is untested on the GPU."""
        lamk2 = lam[lamk2_idx]                     # [n2, 1 or B]
        il6 = c.ep["spec_il"][:, j]                # [6, w, B]
        acc = None
        for ci, (dk, dl) in enumerate(SPEC_COMBOS):
            # lf[w] = LL(j-w+dk, dk);  pin[w] = P(j-dl, w-dk-dl)
            lf = _shift_w(exLB[:, dk], dk, fill=0.0)      # [w, S, B]
            pin = _shift_w(exPF[dl], dk + dl, fill=0.0)   # [w, S, B]
            tP = jnp.einsum("wsb,sp->wpb", pin, Hot_s1_13,
                            preferred_element_type=dtype)
            tL = jnp.einsum("sb,sp->pb", exL3[dl], Hot_s3_13,
                            preferred_element_type=dtype)
            tar = jnp.einsum("wpb,pa->wab", tP * tL[None], Hot_13_ar,
                             preferred_element_type=dtype)
            pL = jnp.einsum("wsb,sk->wkb", lf, Hot_s2_k2,
                            preferred_element_type=dtype)
            pV = jnp.einsum("wab,ak->wkb", tar, Hot_ar_k2,
                            preferred_element_type=dtype)
            eil = jnp.exp(lam_mul(lamk2[None], il6[ci][:, None, :]))
            ok = ((dk + dl) <= c.C)                        # [B]
            t = pL * pV * eil * ok[None, None, :]
            acc = t if acc is None else acc + t
        return acc                                 # [w, n2, B]

    def o_col(rows, c, j, Orows, Pcol, eRrow, g_o2, aR):
        """Orows[w'] = O row j-w' (slot 0 is ignored: okP kills w=0)."""
        prevO = Orows[1]
        oo = chain1(prevO, eRrow, aR, g_o2[None, :])
        mO = _finmax(Orows, (0, 1))[None, None, :]
        exO = jnp.exp(Orows - mO)
        mP = _finmax(Pcol, (0, 1))[None, None, :]
        tot = None
        for b in range(2):
            exP = jnp.exp(Pcol - mP) * rows["eext"][b][:, None, :]
            Gb = jnp.einsum("wab,wcb->acb", exP, exO,
                            preferred_element_type=dtype)
            ob = jnp.einsum("qb,qt->tb",
                            Gb.reshape(S * S, -1), Hop[b],
                            preferred_element_type=dtype)
            tot = ob if tot is None else tot + ob
        op_term = _safe_log(tot, dtype) + mP[0] + mO[0]
        return logadd(oo, op_term)

    def windows_of(tabs, j):
        """Sliding windows of previous rows feeding column j: win[k] is
        row j-1-k.  E/T2 chains only read row j-1; P feeds the internal
        loop back to j-1-Cp; LL/T1/O feed band-wide reads."""
        LLt, Pt, Et, Mt, Bt, T1t, T2t, Ot = tabs
        return dict(
            L=flip(LLt, j - 1, Wp),
            P=flip(Pt, j - 1, Cp),
            T1=flip(T1t, j - 1, Wp),
            E=Et[j - 1 + PAD],
            T2=T2t[j - 1 + PAD],
            O=flip(Ot, j - 1, Wp),
        )

    def push_win(win, cols):
        """Windows for column j+1 from column j's windows + outputs —
        lets a scan step compute KB consecutive columns against ONE
        materialized window read (the flip slices above), halving the
        dominant per-column data movement for KB=2."""
        pre = lambda W, new: jnp.concatenate([new[None], W[:-1]], axis=0)
        return dict(
            L=pre(win["L"], cols["L"]),
            P=pre(win["P"], cols["P"]),
            T1=pre(win["T1"], cols["T1"]),
            E=cols["E"], T2=cols["T2"],
            O=pre(win["O"], cols["O"]),
        )

    # columns per scan step.  KB=2 doubles compile time, which is paid
    # once per (pattern, bucket) across the 135-pattern pipeline, so
    # stay at 1.  The block machinery is kept (and exercised by the
    # unit suite via any even-Lp config if bumped) in case future
    # column bodies get small enough to fuse; KB=2 is unmeasured on the
    # GPU.
    KB = 1

    def cols_fn(win, j, rows, aux, c: ConstFactors):
        """All of column j from the windows of previous rows and the
        per-column row slices (col_rows) — the pure function both the
        forward scan and the reverse (outside) scan differentiate; no
        self-referential table reads remain.  `aux` is the tuple of
        full posterior-injection tensors (scanner path) or None."""
        i_of_w = j - warr
        lamv = _lam2(rows["lam"])[bucket]          # [S, 1 or B]
        eRrow = rows["eR"]                         # [S, B]
        aR = aux_row(aux[0], j - 1) if dims.with_aux else None
        g_o2 = c.gate_O2[jnp.clip(j - 1, 0, Lp - 1)]  # [B]
        B = eRrow.shape[-1]
        negcol = jnp.full((1, Wp + 1, S, B), NEG, dtype)

        # U1: ST_L chain (motif_model.hpp:243-257)
        Lcol = chain(_shift_w(win["L"][0], 1), eRrow, aR)
        Lcol = Lcol.at[0].set(diag_col[:, None])

        # U2: P (TT_P_E / TT_P_P)
        if "p" in _ABLATE:
            Pcol = _shift_w(win["P"][0], 1)
        else:
            Pcol = p_col(rows, aux, c, j, i_of_w, _shift_w(win["E"], 2),
                         _shift_w(win["P"][0], 2), lamv)

        # U3: 2 (TT_2_2 / TT_2_P)
        T2col = logadd(
            chain(_shift_w(win["T2"], 1), eRrow, aR)
            + g_o2[None, None, :],
            Pcol + lam_mul(lamv[None], c.ml2[j][:, None, :]))
        T2col = mask_neg(T2col, c.okB[j][:, None, :])

        # U4: B (TT_B_12); T1F[dk] = T1 row j-dk, dk=0 slot unused
        T1F = jnp.concatenate([negcol, win["T1"]], axis=0)
        Bcol = T2col if "b" in _ABLATE else b_col(c, j, T1F, T2col)

        # U5: 1 (TT_1_2 / TT_1_B)
        T1col = mask_neg(logadd(T2col, Bcol), c.okB[j][:, None, :])

        # U6: M chain (TT_M_M / TT_M_B)
        Mcol = Bcol if "m" in _ABLATE \
            else m_col(rows, aux, c, j, Bcol, Lcol.dtype)

        # U7: E (TT_E_H / TT_E_M / TT_E_P)
        hterm = jnp.where(
            loopm[None, :, None],
            Lcol + lam_mul(lamv[None], c.hp[j][:, None, :]), NEG)
        mterm = Mcol + lam_mul(lamv[None], c.mlE[j][:, None, :])
        if "ep" in _ABLATE:
            ep_term = hterm
        else:
            PF = jnp.concatenate([Pcol[None], win["P"]], axis=0)
            LB = jnp.concatenate([Lcol[None], win["L"]], axis=0)
            ep_term = ep_col(rows, c, j, PF, LB, Lcol)
        Ecol = logadd(logadd(hterm, mterm), ep_term)
        Ecol = mask_neg(Ecol, c.okE[j][:, None, :])

        # U8: O (TT_O_O / TT_O_OP); slot 0 (row j) is zero-weighted
        if "o" in _ABLATE:
            Ocol = chain1(win["O"][0], eRrow, aR, g_o2[None, :])
        else:
            Orows = jnp.concatenate(
                [jnp.full((1, S, B), NEG, dtype), win["O"]], axis=0)
            Ocol = o_col(rows, c, j, Orows, Pcol, eRrow, g_o2, aR)

        return dict(L=Lcol, P=Pcol, E=Ecol, M=Mcol, B=Bcol,
                    T1=T1col, T2=T2col, O=Ocol)

    def _aux_of(d: DiffFactors):
        return (d.auxR, d.auxL, d.auxPL, d.auxPR) if dims.with_aux \
            else None

    def block_cols(win, j0, rows_list, aux, c):
        """KB consecutive columns j0..j0+KB-1 from the windows before
        column j0; later columns' windows are derived in-flight."""
        outs = []
        for t in range(KB):
            cols = cols_fn(win, j0 + t, rows_list[t], aux, c)
            outs.append(cols)
            if t + 1 < KB:
                win = push_win(win, cols)
        return outs

    def col_update(tabs, j0, d: DiffFactors, c: ConstFactors, h):
        outs = block_cols(windows_of(tabs, j0), j0,
                          [col_rows(d, h, j0 + t) for t in range(KB)],
                          _aux_of(d), c)
        order = ("L", "P", "E", "M", "B", "T1", "T2", "O")
        return tuple(
            jax.lax.dynamic_update_slice_in_dim(
                T, jnp.stack([cols[k] for cols in outs]), j0 + PAD,
                axis=0)
            for T, k in zip(tabs, order))

    def init_tabs(B):
        z3 = jnp.full((Lp + 1 + PAD, Wp + 1, S, B), NEG, dtype)
        LLt = z3.at[PAD:, 0, :, :].set(diag_col[:, None])
        Ot = jnp.full((Lp + 1 + PAD, S, B), NEG, dtype)
        Ot = Ot.at[PAD].set(
            jnp.where(jnp.arange(S)[:, None] == end_states[0], 0.0, NEG)
            .astype(dtype))
        return (LLt, z3, z3, z3, z3, z3, z3, Ot)

    def inside_tables(d: DiffFactors, c: ConstFactors):
        h = hoisted(d, c)
        B = c.wsp.shape[-1]

        def body(tabs, j0):
            return col_update(tabs, j0, d, c, h), None

        tabs, _ = jax.lax.scan(body, init_tabs(B),
                               jnp.arange(1, Lp + 1, KB),
                               unroll=_COL_UNROLL)
        return tabs

    def _extract_parts(Ofin, c):
        # parts[b, k] = O[L_b, end_states[k], b]
        Ob = jnp.moveaxis(Ofin, -1, 0)             # [B, rows, S]
        idx = jnp.broadcast_to((c.L + PAD)[:, None, None],
                               (Ob.shape[0], 1, Ob.shape[2]))
        rows = jnp.take_along_axis(Ob, idx, axis=1)[:, 0, :]   # [B, S]
        return rows[:, end_states]                  # [B, 3]

    @jax.custom_vjp
    def dp_parts(d: DiffFactors, c: ConstFactors):
        tabs = inside_tables(d, c)
        return _extract_parts(tabs[-1], c)

    def dp_fwd(d, c):
        tabs = inside_tables(d, c)
        return _extract_parts(tabs[-1], c), (d, c, tabs)

    def dp_bwd(res, gbar):
        """Outside pass: reverse scan whose carry is the COTANGENT of
        the sliding windows (band-depth, ~tens of MB) — not the full
        tables, which XLA was copying wholesale every iteration.  Each
        step re-runs cols_fn for column j against windows read from the
        saved forward tables (exact: cols_fn never reads row >= j) and
        unshifts the window cotangents.

        Row cotangents of the per-read factors come out as STACKED scan
        outputs (one small row set per column) and are assembled into
        the full DiffFactors cotangent after the scan; the hoisted
        energy exponentials h = exp(lam * const) are folded into per-
        column lambda contributions (d h/d lam = const * h) on the spot.
        Accumulating full-tensor d/h cotangents in the carry instead —
        the round-3 design — was over half the backward wall clock."""
        d, c, tabs = res
        B = c.wsp.shape[-1]
        # gbar [B,3] enters the O-column cotangent at j == L_b
        ge = jnp.zeros((S, B), dtype).at[end_states, :].add(gbar.T)

        h = hoisted(d, c)
        aux = _aux_of(d)
        lam2 = _lam2(d.lam)

        # masked d(lam*x)/dlam factors of the hoisted exponentials
        # (lam_mul pins -inf energies, so their lam-derivative is 0)
        def xfac(t):
            return jnp.where(jnp.isneginf(t), 0.0, t)

        xA = xfac(c.ep["misA"])                       # [4, Lp+1, w, B]
        # same rows-leading padded layout as h["emisB"] (hoisted)
        xBc = xfac(c.ep["misB"]).transpose(1, 2, 0, 3)
        xB = jnp.concatenate(
            [jnp.zeros((PAD,) + xBc.shape[1:], dtype), xBc], axis=0)
        xE = xfac(c.ext)                              # [Lp+1, w, B]
        cmask_sz = (dlarr[:, None, None] + dlarr[None, :, None]
                    <= c.C[None, None, :])
        xSZ = [jnp.asarray(xfac(jnp.asarray(SZ_np[x].T, dtype)), dtype)
               for x in range(n_cls)]                 # [dl, u1]

        def lam_chain(dr, rows, j):
            """[2, B] lambda contribution from this column's hoisted-row
            cotangents: sum(g * x * value) per bucket."""
            out = []
            for b in range(2):
                t = (dr["emisA"][b] * xA[:, j] * rows["emisA"][b]
                     ).sum(axis=(0, 1))
                t = t + (dr["emisB"][b] * flip(xB, j, Cp + 1)
                         * rows["emisB"][b]).sum(axis=(0, 1, 2))
                t = t + (dr["eext"][b] * xE[j] * rows["eext"][b]
                         ).sum(axis=0)
                for x in range(n_cls):
                    t = t + (dr["eSZ"][b][x] * xSZ[x][:, :, None]
                             * rows["eSZ"][b][x]).sum(axis=(0, 1))
                out.append(t)
            return jnp.stack(out)                     # [2, B]

        def zwin():
            zc = jnp.zeros((Wp + 1, S, B), dtype)
            return dict(
                L=jnp.zeros((Wp, Wp + 1, S, B), dtype),
                P=jnp.zeros((Cp, Wp + 1, S, B), dtype),
                T1=jnp.zeros((Wp, Wp + 1, S, B), dtype),
                E=zc, T2=zc,
                O=jnp.zeros((Wp, S, B), dtype),
            )

        def unshift(u):
            return jnp.concatenate(
                [u[KB:], jnp.zeros_like(u[:KB])], axis=0)

        def body(carry, jt):
            """One reverse step over the KB-column block topped by jt.
            u_win[k] holds the accumulated cotangent of row jt-k from
            consumers already processed (columns > jt); intra-block
            dataflow (column j0+t feeding j0+t+1..jt) is differentiated
            inside the block's composite vjp."""
            u_win, dlam_dir, dlam_ch, aux_acc = carry
            j0 = jt - (KB - 1)
            wins_prev = windows_of(tabs, j0)
            rows_list = [col_rows(d, h, j0 + t) for t in range(KB)]
            zc = jnp.zeros((Wp + 1, S, B), dtype)
            u_cols_list = []
            for t in range(KB):
                k = KB - 1 - t          # depth of column j0+t in u_win
                top = (k == 0)
                u_cols_list.append(dict(
                    L=u_win["L"][k], P=u_win["P"][k], T1=u_win["T1"][k],
                    E=u_win["E"] if top else zc,
                    T2=u_win["T2"] if top else zc,
                    M=zc, B=zc,
                    O=u_win["O"][k] + ge * (c.L == j0 + t)[None, :],
                ))
            if dims.with_aux:
                _, vjp_fn = jax.vjp(
                    lambda w, rl, a: block_cols(w, j0, rl, a, c),
                    wins_prev, rows_list, aux)
                dw, dr_list, da = vjp_fn(u_cols_list)
                aux_acc = jax.tree.map(jnp.add, aux_acc, da)
            else:
                _, vjp_fn = jax.vjp(
                    lambda w, rl: block_cols(w, j0, rl, None, c),
                    wins_prev, rows_list)
                dw, dr_list = vjp_fn(u_cols_list)
            u_next = dict(
                L=unshift(u_win["L"]) + dw["L"],
                P=unshift(u_win["P"]) + dw["P"],
                T1=unshift(u_win["T1"]) + dw["T1"],
                E=dw["E"], T2=dw["T2"],
                O=unshift(u_win["O"]) + dw["O"],
            )
            for t, dr in enumerate(dr_list):
                dlam_dir = dlam_dir + dr["lam"]
                dlam_ch = dlam_ch + lam_chain(dr, rows_list[t], j0 + t)
            ys = dict(
                eR=jnp.stack([dr["eR"] for dr in dr_list]),
                eL=jnp.stack([dr["eL"] for dr in dr_list]),
                bgl=jnp.stack([dr["bgl"] for dr in dr_list]),
                bgr=jnp.stack([dr["bgr"] for dr in dr_list]),
                pv=jnp.stack([dr["pv"] for dr in dr_list]),
                alphaP=jnp.stack([dr["alphaP"] for dr in dr_list]))
            return (u_next, dlam_dir, dlam_ch, aux_acc), ys

        aux_zero = jax.tree.map(jnp.zeros_like, aux) \
            if dims.with_aux else None
        (_, dlam_dir, dlam_ch, aux_acc), ys = jax.lax.scan(
            body, (zwin(), jnp.zeros_like(d.lam),
                   jnp.zeros((2, B), dtype), aux_zero),
            jnp.arange(Lp, 0, -KB), unroll=_COL_UNROLL)

        # --- assemble full cotangents from the stacked rows (j asc) ---
        # blocks descend; within a block columns ascend -> reverse the
        # block axis only, then flatten to one ascending j axis
        asc = jax.tree.map(
            lambda y: y[::-1].reshape((Lp,) + y.shape[2:]), ys)
        zrow = lambda y: jnp.zeros_like(y[:1])
        d_eR = asc["eR"]                            # rows j-1, bijective
        d_pv = jnp.concatenate([zrow(asc["pv"]), asc["pv"]], axis=0)
        d_alphaP = jnp.concatenate(
            [zrow(asc["alphaP"]), asc["alphaP"]], axis=0)
        # eL/bgl rows clip(j - w): one scatter-add over the static
        # (j-1, w) -> row index map (runs once, outside the scan)
        iw_mat = jnp.asarray(np.clip(
            np.arange(1, Lp + 1)[:, None] - np.arange(Wp + 1)[None, :],
            0, Lp - 1))
        d_eL = jnp.zeros_like(d.eL).at[iw_mat].add(asc["eL"])
        d_bg2 = jnp.zeros_like(d.bg2).at[iw_mat].add(asc["bgl"])
        d_bg2 = d_bg2.at[jnp.arange(Lp)].add(asc["bgr"])
        d_lam = dlam_dir + (dlam_ch.sum(-1) if d.lam.ndim == 1
                            else dlam_ch)
        d_acc = d._replace(
            eR=d_eR, eL=d_eL, bg2=d_bg2, pv=d_pv, alphaP=d_alphaP,
            lam=d_lam,
            auxR=aux_acc[0] if dims.with_aux else None,
            auxL=aux_acc[1] if dims.with_aux else None,
            auxPL=aux_acc[2] if dims.with_aux else None,
            auxPR=aux_acc[3] if dims.with_aux else None)
        c_zero = jax.tree.map(_zero_cotangent, c)
        return d_acc, c_zero

    dp_parts.defvjp(dp_fwd, dp_bwd)
    return dp_parts, inside_tables


def _zero_cotangent(x):
    """Zero cotangent with the dtype JAX expects (float0 for ints/bools)."""
    if jnp.issubdtype(x.dtype, jnp.inexact):
        return jnp.zeros_like(x)
    return np.zeros(x.shape, jax.dtypes.float0)
