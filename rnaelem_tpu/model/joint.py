"""RNAelem joint model: parameters + factor construction + logZ API.

Ties together the grammar compiler, the energy tables and the DP kernels.
Parameter layout mirrors the reference (motif_model.hpp:147-168): one
emission table per '.'/' )' node plus the shared background table 0, a
2-vector lambda, optional softmax parameterization s with
theta = s - logsumexp(s) (profile_hmm.hpp:103-111).

Emission tables are stored as two dense banks — ``singles [n_single, 4]``
and ``pairs [n_pair, 6]`` — indexed through the grammar's table maps, so
lookups are plain gathers on device.

The production sum-semiring DP (ops/dp.py) is natively BATCHED with a
trailing batch axis; ``batch_logZ_parts`` is the primary entry point and
the per-read ``logZ_parts`` is a B=1 wrapper.  The max-semiring CYK twin
(ops/dp_max.py) keeps the per-read factor layout via ``factors``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..alphabet import BP
from ..energy import params as EPARAMS
from ..energy import tables as ET
from ..grammar.profile import Grammar, compile_pattern, null_grammar
from ..ops import dp as DP
from ..ops import dp_max as DPM
from ..ops.semiring import NEG, lse, mask_neg


class Params(NamedTuple):
    singles: jnp.ndarray   # [n_single, 4] log-space theta (or raw s)
    pairs: jnp.ndarray     # [n_pair, 6]
    lam: jnp.ndarray       # [2]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static configuration; hashable so jitted builders cache per config."""
    pattern: str
    Lp: int
    max_span: int = 50
    max_iloop: int = 30
    min_bpp: float = 1e-4
    energy: str = EPARAMS.T2004
    turn: int = 3            # 0 under the NO_TURN test mode
    theta_softmax: bool = False
    no_ene: bool = False
    no_rss: bool = False
    no_prf: bool = False
    no_theta: bool = False   # DBG_NO_THETA test mode
    fix_rss: bool = False    # DBG_FIX_RSS test mode
    with_aux: bool = False
    tau: float = 0.1
    rho_s: float = 0.0
    rho_theta: float = 0.0
    rho_lambda: float = 0.0
    lambda_prior: float = -1.0
    s_prior: float = 0.0
    dtype: str = "float64"

    @property
    def Wp(self) -> int:
        return min(self.Lp, self.max_span)

    @property
    def Cp(self) -> int:
        return max(1, min(self.max_iloop, self.Wp))


class SeqData(NamedTuple):
    """Per-sequence device inputs (padded to Lp)."""
    seq: jnp.ndarray       # [Lp] int32 codes, 0 beyond L
    ws: jnp.ndarray        # [Lp] positional log-weights (0 beyond L)
    L: jnp.ndarray         # scalar int32
    has_motif: jnp.ndarray  # scalar bool (ws sentinel == 0,
    #                         motif_model.hpp:62-70)
    rss_pair: jnp.ndarray  # [Lp+1, Wp+1] bool fixed-structure pairs
    #                         (all False unless fix_rss)
    dots: jnp.ndarray      # [Lp] bool: rss '.' marks (True if not fix_rss)


def make_seqdata(cfg: ModelConfig, seq_codes, quals=None, rss: str = "",
                 np_mod=np) -> SeqData:
    """Host-side packing of one read into padded arrays.

    quals: int phred array of length L+1 (the trailing element is the
    has-motif sentinel, kmer-psp.py:66) or None for flat weights.
    """
    L = len(seq_codes)
    Lp, Wp = cfg.Lp, cfg.Wp
    seq = np.zeros(Lp, np.int32)
    seq[:L] = seq_codes
    ws = np.zeros(Lp, np.float64)
    has_motif = False
    if quals is not None:
        q = np.asarray(quals)
        cnt = np.bincount(q[:-1], minlength=127 - 33)
        mode = int(np.flatnonzero(cnt == cnt.max())[-1])
        ws[:L] = np.log((0.01 + q[:-1]) / (0.01 + mode))
        has_motif = (q[-1] == 0)
    rss_pair = np.zeros((Lp + 1, Wp + 1), bool)
    dots = np.ones(Lp, bool)
    if cfg.fix_rss and rss:
        dots[:] = False
        dots[:L] = np.frombuffer(rss.encode(), np.uint8) == ord(".")
        stack = []
        for p, ch in enumerate(rss):
            if ch == "(":
                stack.append(p)
            elif ch == ")":
                i = stack.pop()
                jj, w = p + 1, p + 1 - i
                if w <= Wp:
                    rss_pair[jj, w] = True
    # HOST arrays: a batch is np.stack'd and shipped as ONE transfer
    # per field (stack_reads) instead of 6 device dispatches per read
    return SeqData(
        seq=seq, ws=ws,
        L=np.int32(L), has_motif=np.bool_(has_motif),
        rss_pair=rss_pair, dots=dots)


def init_params(g: Grammar, cfg: ModelConfig, dtype) -> Params:
    """Flat initialization: s = 0 -> theta = -log(arity)
    (profile_hmm.hpp:286-313)."""
    ns = int((g.single_table_index >= 0).sum())
    npair = max(1, g.n_pair_tables)
    if cfg.theta_softmax:
        singles = jnp.zeros((ns, 4), dtype)
        pairs = jnp.zeros((npair, 6), dtype)
    else:
        singles = jnp.full((ns, 4), -np.log(4.0), dtype)
        pairs = jnp.full((npair, 6), -np.log(6.0), dtype)
    return Params(singles=singles, pairs=pairs,
                  lam=jnp.ones((2,), dtype))


def pack_params(g: Grammar, p: Params) -> np.ndarray:
    """Reference order: tables in creation order, then lambda
    (motif_model.hpp:147-157)."""
    out = []
    for t, sz in enumerate(g.table_sizes):
        if sz == 6:
            out.append(np.asarray(p.pairs[g.pair_table_index[t]]))
        else:
            out.append(np.asarray(p.singles[g.single_table_index[t]]))
    out.append(np.asarray(p.lam))
    return np.concatenate(out)


def unpack_params(g: Grammar, flat, like: Params) -> Params:
    flat = np.asarray(flat)
    singles = np.array(like.singles)
    pairs = np.array(like.pairs)
    k = 0
    for t, sz in enumerate(g.table_sizes):
        if sz == 6:
            pairs[g.pair_table_index[t]] = flat[k:k + 6]
            k += 6
        else:
            singles[g.single_table_index[t]] = flat[k:k + 4]
            k += 4
    lam = flat[k:k + 2]
    return Params(singles=jnp.asarray(singles, like.singles.dtype),
                  pairs=jnp.asarray(pairs, like.pairs.dtype),
                  lam=jnp.asarray(lam, like.lam.dtype))


def effective_theta(cfg: ModelConfig, p: Params) -> Params:
    if not cfg.theta_softmax:
        return p
    return Params(
        singles=p.singles - lse(p.singles, axis=-1)[:, None],
        pairs=p.pairs - lse(p.pairs, axis=-1)[:, None],
        lam=p.lam)


class _Kernels(NamedTuple):
    g: Grammar
    gnull: Grammar
    dp_parts: object          # batched sum-semiring DP
    inside_tables: object
    dp_parts_null: object
    dims: DP.Dims
    dims_max: DPM.Dims        # per-read layout for the CYK twin
    tab: dict


@functools.lru_cache(maxsize=32)
def kernels(cfg: ModelConfig) -> _Kernels:
    g = compile_pattern(cfg.pattern)
    gn = null_grammar()
    dtype = jnp.dtype(cfg.dtype)
    tab = ET.device_tables(cfg.energy, dtype)
    ltau = float(np.log(cfg.tau)) if cfg.tau > 0 else -np.inf
    dims = DP.Dims(Lp=cfg.Lp, Wp=cfg.Wp, Cp=cfg.Cp, S=g.S,
                   no_ene=cfg.no_ene, fix_rss=cfg.fix_rss,
                   with_aux=cfg.with_aux, ltau=ltau)
    dp_parts, inside_tables = DP.build_dp(g, dims, tab, dtype)
    dims_n = DP.Dims(Lp=cfg.Lp, Wp=cfg.Wp, Cp=cfg.Cp, S=1,
                     no_ene=cfg.no_ene, fix_rss=cfg.fix_rss,
                     with_aux=False, ltau=ltau)
    dp_parts_null, _ = DP.build_dp(gn, dims_n, tab, dtype)
    dims_max = DPM.Dims(Lp=cfg.Lp, Wp=cfg.Wp, Cp=cfg.Cp, S=g.S,
                        QC=48, no_ene=cfg.no_ene, fix_rss=cfg.fix_rss,
                        with_aux=cfg.with_aux)
    return _Kernels(g=g, gnull=gn, dp_parts=dp_parts,
                    inside_tables=inside_tables,
                    dp_parts_null=dp_parts_null, dims=dims,
                    dims_max=dims_max, tab=tab)


def _band_masks(cfg: ModelConfig, k: _Kernels, sd: SeqData, bp_ok):
    """is_parsable masks in (j, w) layout (energy_model.hpp:289-338)."""
    Lp, Wp = cfg.Lp, cfg.Wp
    j = jnp.arange(Lp + 1)[:, None]
    w = jnp.arange(Wp + 1)[None, :]
    i = j - w
    L = sd.L
    W = jnp.minimum(L, cfg.max_span)
    # w > 0 is a hard invariant of the DP's custom VJP: the O-column
    # update reads P row j at width 0, which must be zero-weighted for
    # the reverse column re-run to reproduce forward values (ops/dp.py
    # dp_bwd); arbitrary bp_ok inputs (fix_rss, external caches) are
    # forced through it here.
    okP = (i >= 0) & (w > 0) & (w <= W) & bp_ok
    # okE: pair (i-1, j) => bp cell (j+1, w+2)
    src = jnp.pad(bp_ok, ((0, 1), (0, 2)))[1:, 2:]
    okE = (i > 0) & (w + 2 <= W) & src
    m_min = 4 if cfg.turn == 0 else 2 * (2 + cfg.turn)
    okM = (i > 0) & (j < L) & (w <= W) & (w >= m_min)
    # left_bp_ok: cumulative over widths at fixed i
    iw_rows = jnp.clip(jnp.arange(Lp + 1)[:, None] + w, 0, Lp)
    bp_iw = bp_ok[iw_rows, w] & (jnp.arange(Lp + 1)[:, None] + w <= Lp)
    cum_iw = jnp.cumsum(bp_iw.astype(jnp.int32), axis=1) > 0
    lbp = cum_iw[jnp.clip(i, 0, Lp), w] & (i >= 0)
    okB = (w <= W) & lbp
    return okP, okE, okM, okB


def _complementary_bp(cfg: ModelConfig, k, sd: SeqData):
    Lp, Wp = cfg.Lp, cfg.Wp
    j = jnp.arange(Lp + 1)[:, None]
    w = jnp.arange(Wp + 1)[None, :]
    i = j - w
    L = sd.L
    W = jnp.minimum(L, cfg.max_span)
    wmin = 1 if cfg.turn == 0 else cfg.turn + 2
    t = k.tab["bp"][sd.seq[jnp.clip(i, 0, Lp - 1)],
                    sd.seq[jnp.clip(j - 1, 0, Lp - 1)]]
    return (i >= 0) & (w >= wmin) & (w <= W) & (j <= L) & (t > 0)


def _const_factors_single(cfg: ModelConfig, k: _Kernels, sd: SeqData,
                          bp_ok, dtype, null=False):
    """Per-read constants in the dp_max (CYK) layout, incl. the grammar
    transition matrices the host traceback reads."""
    Lp, Wp = cfg.Lp, cfg.Wp
    okP, okE, okM, okB = _band_masks(cfg, k, sd, bp_ok)
    L = sd.L
    W = jnp.minimum(L, cfg.max_span)
    C = jnp.minimum(W - 2 - (2 if cfg.turn == 0 else 5), cfg.max_iloop)
    tab = k.tab
    hp = ET.hairpin_scores(tab, sd.seq, L, W, Wp, cfg.no_ene)
    stk = ET.stack_scores(tab, sd.seq, Wp, cfg.no_ene)
    ext = ET.exterior_scores(tab, sd.seq, L, Wp, cfg.no_ene)
    ml2 = ET.ml2_scores(tab, sd.seq, L, Wp, cfg.no_ene)
    mlE = ET.mlE_scores(tab, sd.seq, L, Wp, cfg.no_ene)
    dots_cum = jnp.concatenate(
        [jnp.zeros(1, jnp.int32),
         jnp.cumsum(sd.dots.astype(jnp.int32))])
    if cfg.fix_rss:
        j = jnp.arange(Lp + 1)[:, None]
        w = jnp.arange(Wp + 1)[None, :]
        i = jnp.clip(j - w, 0, Lp)
        all_dots = (dots_cum[jnp.clip(j, 0, Lp)]
                    - dots_cum[i]) == w
        hp = mask_neg(hp, all_dots)
        gate = jnp.where(sd.dots, 0.0, NEG).astype(dtype)
    else:
        gate = jnp.zeros((Lp,), dtype)
    g = k.gnull if null else k.g
    from ..ops import ep_fast as EPF
    ep = EPF.seq_tables(tab, sd.seq, Lp, Wp, cfg.no_ene, dtype)
    ltau = np.log(cfg.tau) if cfg.tau > 0 else -np.inf
    TR = jnp.asarray(np.where(g.rt, np.where(g.rt_tau, ltau, 0.0),
                              -np.inf), dtype)
    TL = jnp.asarray(np.where(g.lt, np.where(g.lt_tau, ltau, 0.0),
                              -np.inf), dtype)
    TPm = jnp.asarray(np.where(g.pt_tau, ltau, 0.0), dtype)
    # sd rows may be host numpy (make_seqdata); coerce so factors built
    # eagerly still trace cleanly when closed over by a jitted kernel
    wsp = jnp.asarray(sd.ws, dtype) if not null \
        else jnp.zeros((Lp,), dtype)
    return DPM.ConstFactors(
        wsp=wsp, TR=TR, TL=TL, TPm=TPm,
        hp=hp.astype(dtype), stk=stk.astype(dtype), ext=ext.astype(dtype),
        ml2=ml2.astype(dtype), mlE=mlE.astype(dtype),
        okP=okP, okE=okE, okM=okM, okB=okB,
        gate_O2=gate, gate_M=gate, seq=jnp.asarray(sd.seq), C=C, L=L,
        dots_cum=dots_cum, ep=ep)


def _diff_factors_single(cfg: ModelConfig, params: Params, sd: SeqData,
                         aux, DPmod):
    """Per-read differentiable factors (shared by both DP layouts)."""
    k = kernels(cfg)
    g = k.g
    dtype = jnp.dtype(cfg.dtype)
    Lp, Wp = cfg.Lp, cfg.Wp
    th = effective_theta(cfg, params)
    base = sd.seq[:Lp]
    # DBG_NO_THETA pins theta to log(1)=0 but the reference still
    # accumulates emission counts (test.cpp EMISSION_COUNT_CASES), so the
    # value is zeroed while the gradient path is kept; no_prf removes the
    # profile entirely (counts are skipped too, motif_trainer.hpp:386).
    if cfg.no_theta and not cfg.no_prf:
        th = th._replace(
            singles=th.singles - jax.lax.stop_gradient(th.singles),
            pairs=th.pairs - jax.lax.stop_gradient(th.pairs))
    no_prf = cfg.no_prf

    sidx_r = jnp.asarray(g.single_table_index[g.tid_r])
    sidx_l = jnp.asarray(g.single_table_index[g.tid_l])
    b1 = jnp.clip(base - 1, 0, 3)

    def single_lookup(slot_per_state):
        if no_prf:
            return jnp.zeros((Lp, g.S), dtype)
        v = th.singles[slot_per_state[None, :], b1[:, None]]
        return jnp.where((base > 0)[:, None], v, 0.0)

    eR = single_lookup(sidx_r) + jnp.where(
        jnp.asarray(g.ws_r)[None, :], sd.ws[:, None], 0.0)
    eL = single_lookup(sidx_l) + jnp.where(
        jnp.asarray(g.ws_l)[None, :], sd.ws[:, None], 0.0)
    if no_prf:
        bg2 = jnp.zeros((Lp,), dtype)
    else:
        bg2 = jnp.where(base > 0, th.singles[0, b1], 0.0)

    j = jnp.arange(Lp + 1)[:, None]
    w = jnp.arange(Wp + 1)[None, :]
    i = jnp.clip(j - w, 0, Lp - 1)
    bt = k.tab["bp"][sd.seq[i], sd.seq[jnp.clip(j - 1, 0, Lp - 1)]]
    Tp = max(1, g.n_pair_tables)
    if no_prf:
        pv = jnp.zeros((Lp + 1, Wp + 1, Tp), dtype)
    else:
        pvv = th.pairs[jnp.arange(Tp)[None, None, :],
                       jnp.clip(bt - 1, 0, 5)[..., None]]
        pv = jnp.where((bt > 0)[..., None], pvv, 0.0)

    d = DPmod.DiffFactors(
        eR=eR.astype(dtype), eL=eL.astype(dtype), bg2=bg2.astype(dtype),
        pv=pv.astype(dtype), lam=params.lam.astype(dtype),
        alphaP=jnp.zeros((Lp + 1, Wp + 1), dtype))
    if cfg.with_aux:
        zaux = jnp.zeros((Lp, g.S, g.S), dtype)
        if aux is None:
            aux = dict()
        d = d._replace(
            auxR=aux.get("auxR", zaux), auxL=aux.get("auxL", zaux),
            auxPL=aux.get("auxPL", zaux), auxPR=aux.get("auxPR", zaux))
    return d


def factors(cfg: ModelConfig, params: Params, sd: SeqData, bp_ok,
            aux=None):
    """Per-read (DiffFactors, ConstFactors) in the dp_max/CYK layout."""
    k = kernels(cfg)
    dtype = jnp.dtype(cfg.dtype)
    d = _diff_factors_single(cfg, params, sd, aux, DPM)
    c = _const_factors_single(cfg, k, sd, bp_ok, dtype)
    return d, c


def _to_batched(d_lead, c_lead, params_lam):
    """Leading-batch factor pytrees (from vmap) -> trailing-batch DP
    factors; grammar transition matrices drop out (static in ops/dp.py),
    lambda stays shared."""
    mv = lambda x: jnp.moveaxis(x, 0, -1)
    d = DP.DiffFactors(
        eR=mv(d_lead.eR), eL=mv(d_lead.eL), bg2=mv(d_lead.bg2),
        pv=mv(d_lead.pv), lam=params_lam,
        alphaP=mv(d_lead.alphaP),
        auxR=None if d_lead.auxR is None else mv(d_lead.auxR),
        auxL=None if d_lead.auxL is None else mv(d_lead.auxL),
        auxPL=None if d_lead.auxPL is None else mv(d_lead.auxPL),
        auxPR=None if d_lead.auxPR is None else mv(d_lead.auxPR))
    c = DP.ConstFactors(
        wsp=mv(c_lead.wsp), hp=mv(c_lead.hp), stk=mv(c_lead.stk),
        ext=mv(c_lead.ext), ml2=mv(c_lead.ml2), mlE=mv(c_lead.mlE),
        okP=mv(c_lead.okP), okE=mv(c_lead.okE), okM=mv(c_lead.okM),
        okB=mv(c_lead.okB), gate_O2=mv(c_lead.gate_O2),
        gate_M=mv(c_lead.gate_M), seq=mv(c_lead.seq),
        C=c_lead.C, L=c_lead.L, dots_cum=mv(c_lead.dots_cum),
        ep={kk: mv(vv) for kk, vv in c_lead.ep.items()})
    return d, c


def batch_factors(cfg: ModelConfig, params: Params, sd_b: SeqData,
                  bp_ok_b, aux_b=None):
    """Batched (DiffFactors, ConstFactors) for the production DP.

    sd_b: SeqData with leading batch axis; bp_ok_b: [B, Lp+1, Wp+1];
    aux_b: optional dict of [B, Lp, S, S] tensors.
    """
    k = kernels(cfg)
    dtype = jnp.dtype(cfg.dtype)

    if aux_b is None:
        def one(sd, bp):
            d = _diff_factors_single(cfg, params, sd, None, DPM)
            c = _const_factors_single(cfg, k, sd, bp, dtype)
            return d, c
        d_lead, c_lead = jax.vmap(one)(sd_b, bp_ok_b)
    else:
        def one(sd, bp, aux):
            d = _diff_factors_single(cfg, params, sd, aux, DPM)
            c = _const_factors_single(cfg, k, sd, bp, dtype)
            return d, c
        d_lead, c_lead = jax.vmap(one)(sd_b, bp_ok_b, aux_b)
    return _to_batched(d_lead, c_lead, params.lam.astype(dtype))


def batch_factors_pr(cfg: ModelConfig, params_b: Params, sd_b: SeqData,
                     bp_ok_b):
    """Batched factors from PER-READ parameter copies (leading B axis on
    every Params leaf).  Gradients w.r.t. params_b come back with the
    batch axis intact, giving exact per-read gradient contributions —
    the basis for the order-deterministic host reduction that makes
    single-device and mesh-sharded training bit-identical
    (cf. the reference's text-file all-reduce,
    motif_array_trainer.hpp:20-58, which is also order-deterministic)."""
    k = kernels(cfg)
    dtype = jnp.dtype(cfg.dtype)

    def one(p, sd, bp):
        d = _diff_factors_single(cfg, p, sd, None, DPM)
        c = _const_factors_single(cfg, k, sd, bp, dtype)
        return d, c

    d_lead, c_lead = jax.vmap(one)(params_b, sd_b, bp_ok_b)
    lam_b = jnp.moveaxis(params_b.lam.astype(dtype), 0, -1)   # [2, B]
    return _to_batched(d_lead, c_lead, lam_b)


@functools.partial(jax.jit, static_argnums=(0,))
def _batch_logZ_parts_pr_jit(cfg: ModelConfig, params_b: Params,
                             sd_b: SeqData, bp_ok_b):
    """[B, 3] log partition parts with per-read parameter copies."""
    k = kernels(cfg)
    if cfg.no_rss:
        return jax.vmap(
            lambda p, sd: _linear_parts_one(cfg, p, sd, None)
        )(params_b, sd_b)
    d, c = batch_factors_pr(cfg, params_b, sd_b, bp_ok_b)
    return k.dp_parts(d, c)


def _null_batch_factors(cfg: ModelConfig, k: _Kernels, sd_b: SeqData,
                        bp0_b, dtype):
    """Batched factors for the motif-free McCaskill pass (BPP pruning)."""
    Lp, Wp = cfg.Lp, cfg.Wp
    B = bp0_b.shape[0]
    c_lead = jax.vmap(
        lambda sd, bp: _const_factors_single(cfg, k, sd, bp, dtype,
                                             null=True))(sd_b, bp0_b)
    _, c = _to_batched(
        DPM.DiffFactors(eR=jnp.zeros((B, Lp, 1), dtype),
                        eL=jnp.zeros((B, Lp, 1), dtype),
                        bg2=jnp.zeros((B, Lp), dtype),
                        pv=jnp.zeros((B, Lp + 1, Wp + 1, 1), dtype),
                        lam=jnp.ones((B, 2), dtype),
                        alphaP=jnp.zeros((B, Lp + 1, Wp + 1), dtype)),
        c_lead, jnp.ones((2,), dtype))
    d = DP.DiffFactors(
        eR=jnp.zeros((Lp, 1, B), dtype), eL=jnp.zeros((Lp, 1, B), dtype),
        bg2=jnp.zeros((Lp, B), dtype),
        pv=jnp.zeros((Lp + 1, Wp + 1, 1, B), dtype),
        lam=jnp.ones((2,), dtype),
        alphaP=jnp.zeros((Lp + 1, Wp + 1, B), dtype))
    return d, c


@functools.partial(jax.jit, static_argnums=(0,))
def _bpp_posterior_batch_jit(cfg: ModelConfig, sd_b: SeqData):
    """Batched base-pair probabilities from the motif-free pass
    (energy_model.hpp:188-266): grad of logZ wrt the injected per-pair
    log-factor alphaP is exactly the pair posterior."""
    k = kernels(cfg)
    dtype = jnp.dtype(cfg.dtype)
    bp0 = jax.vmap(lambda sd: _complementary_bp(cfg, k, sd))(sd_b)
    if cfg.fix_rss:
        bp0 = sd_b.rss_pair
    d, c = _null_batch_factors(cfg, k, sd_b, bp0, dtype)

    def z_of_alpha(alphaP):
        dd = d._replace(alphaP=alphaP)
        parts = k.dp_parts_null(dd, c)       # [B, 3]
        return parts[:, 0]

    z, vjp = jax.vjp(z_of_alpha, d.alphaP)
    (post,) = vjp(jnp.ones_like(z))
    return z, jnp.moveaxis(post, -1, 0), bp0


@functools.partial(jax.jit, static_argnums=(0,))
def _effective_bp_mask_batch_jit(cfg: ModelConfig, sd_b: SeqData):
    """Batched bp_ok after min-BPP pruning; also returns bpp_eff [B]
    (energy_model.hpp:211-266)."""
    k = kernels(cfg)
    bp0 = jax.vmap(lambda sd: _complementary_bp(cfg, k, sd))(sd_b)
    total = jnp.maximum(bp0.sum(axis=(1, 2)), 1)
    if cfg.fix_rss:
        return sd_b.rss_pair, sd_b.rss_pair.sum(axis=(1, 2)) / total
    if cfg.min_bpp <= 0 or cfg.no_rss:
        return bp0, jnp.ones(bp0.shape[0], jnp.dtype(cfg.dtype))
    _, post, _ = _bpp_posterior_batch_jit(cfg, sd_b)
    keep = bp0 & (jnp.log(jnp.maximum(post, 1e-300))
                  >= np.log(cfg.min_bpp))
    return keep, keep.sum(axis=(1, 2)) / total


@functools.partial(jax.jit, static_argnums=(0,))
def _batch_logZ_parts_jit(cfg: ModelConfig, params: Params, sd_b: SeqData,
                          aux_b=None, bp_ok_b=None):
    """[B, 3] log partition parts at end states (0,0), (0,M-2), (0,M-1).

    part_func(ari, nasi) of the reference (motif_trainer.hpp:108-112) is
    a logsumexp over a subset of these.
    """
    k = kernels(cfg)
    if cfg.no_rss:
        return jax.vmap(
            lambda sd, aux: _linear_parts_one(cfg, params, sd, aux)
        )(sd_b, aux_b) if aux_b is not None else jax.vmap(
            lambda sd: _linear_parts_one(cfg, params, sd, None))(sd_b)
    if bp_ok_b is None:
        bp_ok_b, _ = _effective_bp_mask_batch_jit(cfg, sd_b)
    d, c = batch_factors(cfg, params, sd_b, bp_ok_b, aux_b)
    return k.dp_parts(d, c)


def batch_logZ_parts(cfg: ModelConfig, params: Params, sd_b: SeqData,
                     aux_b=None, bp_ok_b=None):
    _warm(cfg)
    return _batch_logZ_parts_jit(cfg, params, sd_b, aux_b, bp_ok_b)


def _expand1(tree):
    return jax.tree.map(lambda x: jnp.asarray(x)[None], tree)


@functools.partial(jax.jit, static_argnums=(0,))
def _effective_bp_mask_jit(cfg: ModelConfig, sd: SeqData):
    """Per-read wrapper over the batched pruning pass."""
    keep, eff = _effective_bp_mask_batch_jit(cfg, _expand1(sd))
    return keep[0], eff[0]


@functools.partial(jax.jit, static_argnums=(0, 5))
def _logZ_parts_jit(cfg: ModelConfig, params: Params, sd: SeqData,
                    aux=None, bp_ok=None, with_eff=False):
    """Per-read wrapper over the batched DP (B = 1)."""
    if cfg.no_rss:
        lp = _linear_parts_one(cfg, params, sd, aux)
        if with_eff:
            return lp, jnp.asarray(1.0)
        return lp
    sd_b = _expand1(sd)
    if bp_ok is None:
        bp_ok_b, eff = _effective_bp_mask_batch_jit(cfg, sd_b)
        eff = eff[0]
    else:
        bp_ok_b, eff = bp_ok[None], jnp.asarray(1.0)
    aux_b = None if aux is None else _expand1(aux)
    parts = _batch_logZ_parts_jit(cfg, params, sd_b, aux_b, bp_ok_b)[0]
    if with_eff:
        return parts, eff
    return parts


def _linear_parts_one(cfg: ModelConfig, params: Params, sd: SeqData,
                      aux=None):
    """no-rss mode: plain forward chain over O states
    (motif_model.hpp:170-190)."""
    k = kernels(cfg)
    g = k.g
    dtype = jnp.dtype(cfg.dtype)
    th = effective_theta(cfg, params)
    if cfg.no_theta and not cfg.no_prf:
        th = th._replace(
            singles=th.singles - jax.lax.stop_gradient(th.singles),
            pairs=th.pairs - jax.lax.stop_gradient(th.pairs))
    base = sd.seq
    b1 = jnp.clip(base - 1, 0, 3)
    sidx_r = jnp.asarray(g.single_table_index[g.tid_r])
    if cfg.no_prf:
        v = jnp.zeros((cfg.Lp, g.S), dtype)
    else:
        v = jnp.where((base > 0)[:, None],
                      th.singles[sidx_r[None, :], b1[:, None]], 0.0)
    eR = v + jnp.where(jnp.asarray(g.ws_r)[None, :], sd.ws[:, None], 0.0)
    ltau = np.log(cfg.tau) if cfg.tau > 0 else -np.inf
    TR = jnp.asarray(np.where(g.rt, np.where(g.rt_tau, ltau, 0.0),
                              -np.inf), dtype)
    auxR = None if aux is None else aux.get("auxR")

    end_states = jnp.asarray(g.end_states)
    o0 = jnp.where(jnp.arange(g.S) == end_states[0], 0.0, NEG)

    def step(o, p):
        t = o[None, :] + TR
        if auxR is not None:
            t = t + auxR[p]
        nxt = lse(t, axis=-1) + eR[p]
        return jnp.where(p < sd.L, nxt, o), None

    oL, _ = jax.lax.scan(step, o0.astype(dtype), jnp.arange(cfg.Lp))
    return oL[end_states]


def part_func(parts, ari=True, nasi=True):
    """sumL over selected end states (motif_trainer.hpp:108-112)."""
    sel = jnp.asarray([nasi, ari, ari])
    return lse(jnp.where(sel, parts, NEG), axis=-1)


def _warm(cfg: ModelConfig):
    """Build kernels/constants eagerly: jnp arrays created while tracing
    would leak tracers into the lru caches (see tests/conftest note)."""
    kernels(cfg)


def bpp_posterior(cfg: ModelConfig, sd: SeqData):
    _warm(cfg)
    z, post, bp0 = _bpp_posterior_batch_jit(cfg, _expand1(sd))
    return z[0], post[0], bp0[0]


def effective_bp_mask(cfg: ModelConfig, sd: SeqData):
    _warm(cfg)
    keep, eff = _effective_bp_mask_batch_jit(cfg, _expand1(sd))
    return keep[0], eff[0]


def logZ_parts(cfg: ModelConfig, params: Params, sd: SeqData, aux=None,
               bp_ok=None, with_eff=False):
    _warm(cfg)
    return _logZ_parts_jit(cfg, params, sd, aux, bp_ok, with_eff)


def linear_parts(cfg: ModelConfig, params: Params, sd: SeqData, aux=None):
    _warm(cfg)
    return _linear_parts_one(cfg, params, sd, aux)
