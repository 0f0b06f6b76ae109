"""Motif profile grammar compiler.

Compiles a dot-bracket motif pattern (``(``, ``)``, ``.``, ``*`` plus the
implicit flanking ``z``/``o`` background nodes) into dense transition
tensors consumed by the DP kernels.

This reimplements the semantics of the reference state-machine builder
(/root/reference/RNAelem/profile_hmm.hpp:206-463): nodes -> edges ->
emission tables -> reachability closure -> interval states -> per-kind
transition lists -> bifurcation state tuples.  Instead of per-state C++
vectors, the output is a set of [S,S] masks, node-index vectors and index
triple/quadruple arrays, which the jitted kernels use as static constants.

Interval-state conventions (matching the reference):
  * a state is a reachable node interval (l, r);
  * RIGHT transitions (used by the O/2/L linear chains) go source
    s1=(l,h) -> target s=(l,r) with h an in-edge of r; the consumed base is
    emitted by node ``r`` of the *target* (motif_model.hpp:301-313);
  * LEFT transitions (multiloop M chain) go source s1 -> target s where
    s.l is an in-edge of s1.l; the base is emitted by node ``s1.l`` of the
    *source* (motif_model.hpp:346-358);
  * PAIR transitions close (i, j-1): target s=(hl,hr) with node[hr]==')'
    emits the base pair from hr's pair table, background targets emit two
    independent background bases (profile_hmm.hpp:417-448,113-135);
  * O_OP/B_12 splits and E_P (internal loop) quadruples are index tuples
    (profile_hmm.hpp:451-463, motif_model.hpp:315-335).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

BG_NODES = ("z", "o", "*")
EMIT_RIGHT_NODES = ("z", ".", "*", "o")
WS_NODES = (".", "(", ")")


def normalize_pattern(pattern: str) -> str:
    """Collapse '**' runs and strip flanking '*'s (profile_hmm.hpp:188-204)."""
    out = []
    for ch in pattern:
        if ch == "*" and out and out[-1] == "*":
            continue
        out.append(ch)
    s = "".join(out).strip("*")
    return s


@dataclasses.dataclass
class Grammar:
    pattern: str                 # original pattern
    reg_pattern: str             # normalized pattern
    nodes: str                   # 'z' + reg_pattern + 'o'
    M: int
    S: int
    pair: np.ndarray             # [M] partner node or -1
    theta_id: np.ndarray         # [M] emission table id or -1
    table_sizes: List[int]       # per-table emission arity (4 or 6)
    state_l: np.ndarray          # [S]
    state_r: np.ndarray          # [S]
    n2s: np.ndarray              # [M,M] -> state id or -1
    loop_mask: np.ndarray        # [S] bool, states usable inside loops
    diag_mask: np.ndarray        # [S] bool, l == r
    lam_bucket: np.ndarray       # [S] 0 if l==r else 1 (motif_model.hpp:117)

    # RIGHT: target s x source s1
    rt: np.ndarray               # [S,S] bool
    rt_tau: np.ndarray           # [S,S] bool
    # LEFT: target s x source s1
    lt: np.ndarray               # [S,S] bool
    lt_tau: np.ndarray           # [S,S] bool
    # PAIR: target s x source s1
    pt: np.ndarray               # [S,S] bool
    pt_tau: np.ndarray           # [S,S] bool
    pt_isbp: np.ndarray          # [S,S] bool (emits from a pair table)
    pt_tab: np.ndarray           # [S,S] pair-table id (0 where not bp)
    pt_wl: np.ndarray            # [S,S] bool, ws applies at left base
    pt_wr: np.ndarray            # [S,S] bool, ws applies at right base

    op_tuples: np.ndarray        # [n_op, 3]  (s, s1 pair, s2 outer)
    b12_tuples: np.ndarray       # [n_b, 3]   (s, s1 left(1), s2 right(2))
    ep_tuples: np.ndarray        # [n_q, 4]   (s, s1 pair, s2 left-L, s3 right-L)

    end_states: np.ndarray       # [3] ids of (0,0), (0,M-2), (0,M-1)
    # emission gather helpers
    tid_r: np.ndarray            # [S] theta table id of node r (clipped >=0)
    tid_l: np.ndarray            # [S] theta table id of node l (clipped >=0)
    ws_r: np.ndarray             # [S] bool: positional weight at right emit
    ws_l: np.ndarray             # [S] bool: positional weight at left emit
    n_pair_tables: int
    pair_table_index: np.ndarray  # [n_tables] -> dense pair-table slot or -1
    single_table_index: np.ndarray  # [n_tables] -> dense single slot or -1


def compile_pattern(pattern: str) -> Grammar:
    reg = normalize_pattern(pattern)
    if not reg:
        raise ValueError("empty motif")
    nodes = "z" + reg + "o"
    M = len(nodes)

    # bracket matching
    pair = np.full(M, -1, dtype=np.int64)
    stack: List[int] = []
    for h, c in enumerate(nodes):
        if c in "(<":
            stack.append(h)
        elif c in ")>":
            if not stack:
                raise ValueError("unmatched brackets in pattern " + pattern)
            hl = stack.pop()
            pair[hl], pair[h] = h, hl
    if stack:
        raise ValueError("unmatched brackets in pattern " + pattern)

    # node graph: chain edges, '*'-skip edges, self loops (not on '<'/'>')
    edge_to = [[] for _ in range(M)]    # edge_to[h]: nodes with edge into h
    edge_from = [[] for _ in range(M)]  # edge_from[h]: successors of h
    for h in range(M):
        if h > 0:
            if nodes[h - 1] == "*":
                edge_to[h].append(h - 2)
                edge_from[h - 2].append(h)
            edge_to[h].append(h - 1)
            edge_from[h - 1].append(h)
        if nodes[h] not in "<>":
            edge_to[h].append(h)
            edge_from[h].append(h)

    # emission tables: table 0 shared background; one per '.' (4) / ')' (6)
    theta_id = np.full(M, -1, dtype=np.int64)
    table_sizes = [4]
    for h, c in enumerate(nodes):
        if c == ")":
            theta_id[h] = len(table_sizes)
            table_sizes.append(6)
        elif c == ".":
            theta_id[h] = len(table_sizes)
            table_sizes.append(4)
        elif c in BG_NODES:
            theta_id[h] = 0
        elif c in "(<>":
            pass
        else:
            raise ValueError(f"bad motif char: {c!r}")

    # reachability (profile_hmm.hpp:316-354)
    reach = np.zeros((M, M), dtype=bool)
    reach_loop = np.zeros((M, M), dtype=bool)
    for h, c in enumerate(nodes):
        if c in ")>":
            for h1 in edge_to[pair[h]]:
                reach[h1, h] = True
                if c == ">":
                    reach_loop[h1, h] = True
        elif c in "(<":
            pass
        else:
            for h1 in edge_to[h]:
                reach[h1, h] = True
                reach_loop[h1, h] = True
        reach[h, h] = True
        reach_loop[h, h] = True
    # Warshall closure
    for k in range(M):
        reach |= np.outer(reach[:, k], reach[k, :])
        reach_loop |= np.outer(reach_loop[:, k], reach_loop[k, :])

    # interval states, ordered as the reference enumerates them
    # (r ascending, l descending; profile_hmm.hpp:369-375)
    states: List[Tuple[int, int]] = []
    n2s = np.full((M, M), -1, dtype=np.int64)
    for hr in range(M):
        for hl in range(hr, -1, -1):
            if reach[hl, hr]:
                n2s[hl, hr] = len(states)
                states.append((hl, hr))
    S = len(states)
    state_l = np.array([s[0] for s in states], dtype=np.int64)
    state_r = np.array([s[1] for s in states], dtype=np.int64)
    loop_mask = np.array([reach_loop[l, r] for l, r in states], dtype=bool)
    diag_mask = state_l == state_r

    rt = np.zeros((S, S), dtype=bool)
    rt_tau = np.zeros((S, S), dtype=bool)
    for sid, (l, r) in enumerate(states):
        if nodes[r] in EMIT_RIGHT_NODES:
            for h in edge_to[r]:
                if l <= h and reach[l, h]:
                    s1 = n2s[l, h]
                    rt[sid, s1] = True
                    rt_tau[sid, s1] = (r == h) and nodes[r] == "."

    # loop-left: loop_left_trans[Y] contains X with Y=(h, X.r), h in-edge
    # of X.l; in the DP the target covers the larger region and is keyed Y.
    lt = np.zeros((S, S), dtype=bool)
    lt_tau = np.zeros((S, S), dtype=bool)
    for sid, (l, r) in enumerate(states):  # X = (l, r), emitting node l
        if nodes[l] in EMIT_RIGHT_NODES:
            for h in edge_to[l]:
                if h <= r and reach[h, r]:
                    y = n2s[h, r]
                    lt[y, sid] = True
                    lt_tau[y, sid] = (h == l) and nodes[h] == "."

    pt = np.zeros((S, S), dtype=bool)
    pt_tau = np.zeros((S, S), dtype=bool)
    pt_isbp = np.zeros((S, S), dtype=bool)
    pt_tab = np.zeros((S, S), dtype=np.int64)
    for hr in range(M):
        if nodes[hr] in ")>":
            kl = pair[hr]
            for hl in edge_to[kl]:
                sid = n2s[hl, hr]
                if sid < 0:
                    continue
                for kr in edge_to[hr]:
                    if reach[kl, kr]:
                        s1 = n2s[kl, kr]
                        pt[sid, s1] = True
                        if nodes[hr] == ")":
                            pt_isbp[sid, s1] = True
                            pt_tab[sid, s1] = theta_id[hr]
                        pt_tau[sid, s1] = (hr == kr) and nodes[hr] == ")"
    for sid, (l, r) in enumerate(states):
        if nodes[r] in BG_NODES:
            for hl in edge_from[l]:
                if nodes[hl] in BG_NODES:
                    for hr in edge_to[r]:
                        if reach[hl, hr]:
                            s1 = n2s[hl, hr]
                            pt[sid, s1] = True

    pt_wl = np.zeros((S, S), dtype=bool)
    pt_wr = np.zeros((S, S), dtype=bool)
    for sid in range(S):
        for s1 in range(S):
            if pt[sid, s1]:
                pt_wl[sid, s1] = nodes[state_l[s1]] in WS_NODES
                pt_wr[sid, s1] = nodes[state_r[sid]] in WS_NODES

    op, b12 = [], []
    for sid, (l, r) in enumerate(states):
        for h in range(l, r + 1):
            if reach[l, h] and reach[h, r]:
                op.append((sid, n2s[h, r], n2s[l, h]))
                b12.append((sid, n2s[l, h], n2s[h, r]))

    ep = []
    loop_states = [i for i in range(S) if loop_mask[i]]
    for s2 in loop_states:
        for s3 in loop_states:
            if state_r[s3] < state_l[s2]:
                continue
            if not reach[state_r[s2], state_l[s3]]:
                continue
            if not reach[state_l[s2], state_r[s3]]:
                continue
            s = n2s[state_l[s2], state_r[s3]]
            s1 = n2s[state_r[s2], state_l[s3]]
            ep.append((s, s1, s2, s3))

    tid_r = np.maximum(theta_id[state_r], 0)
    tid_l = np.maximum(theta_id[state_l], 0)
    ws_r = np.array([nodes[r] == "." for r in state_r], dtype=bool)
    ws_l = np.array([nodes[l] == "." for l in state_l], dtype=bool)

    # dense slots: split tables into single-emission (4) and pair (6) banks
    pair_table_index = np.full(len(table_sizes), -1, dtype=np.int64)
    single_table_index = np.full(len(table_sizes), -1, dtype=np.int64)
    np_, ns_ = 0, 0
    for t, sz in enumerate(table_sizes):
        if sz == 6:
            pair_table_index[t] = np_
            np_ += 1
        else:
            single_table_index[t] = ns_
            ns_ += 1

    end = np.array([n2s[0, 0], n2s[0, M - 2], n2s[0, M - 1]], dtype=np.int64)
    if (end < 0).any():
        raise ValueError("pattern end states unreachable: " + pattern)

    return Grammar(
        pattern=pattern, reg_pattern=reg, nodes=nodes, M=M, S=S,
        pair=pair, theta_id=theta_id, table_sizes=table_sizes,
        state_l=state_l, state_r=state_r, n2s=n2s,
        loop_mask=loop_mask, diag_mask=diag_mask,
        lam_bucket=(~diag_mask).astype(np.int64),
        rt=rt, rt_tau=rt_tau, lt=lt, lt_tau=lt_tau,
        pt=pt, pt_tau=pt_tau, pt_isbp=pt_isbp, pt_tab=pt_tab,
        pt_wl=pt_wl, pt_wr=pt_wr,
        op_tuples=np.array(op, dtype=np.int64).reshape(-1, 3),
        b12_tuples=np.array(b12, dtype=np.int64).reshape(-1, 3),
        ep_tuples=np.array(ep, dtype=np.int64).reshape(-1, 4),
        end_states=end,
        tid_r=tid_r, tid_l=tid_l, ws_r=ws_r, ws_l=ws_l,
        n_pair_tables=np_, pair_table_index=pair_table_index,
        single_table_index=single_table_index,
    )


NULL_PATTERN = "~NULL~"


def null_grammar() -> Grammar:
    """Single-state grammar turning the joint DP into plain McCaskill
    (used for the BPP pruning pre-pass, energy_model.hpp:549-661)."""
    g = compile_pattern(".")
    # collapse to one state: keep only the diagonal state (0,0) semantics
    S = 1
    one = np.ones((1, 1), dtype=bool)
    zero = np.zeros((1, 1), dtype=bool)
    zi = np.zeros((1, 1), dtype=np.int64)
    tup = np.array([[0, 0, 0]], dtype=np.int64)
    return Grammar(
        pattern=NULL_PATTERN, reg_pattern="", nodes="z", M=1, S=S,
        pair=np.array([-1]), theta_id=np.array([0]), table_sizes=[4],
        state_l=np.array([0]), state_r=np.array([0]),
        n2s=np.array([[0]]), loop_mask=np.ones(1, bool),
        diag_mask=np.ones(1, bool), lam_bucket=np.zeros(1, np.int64),
        rt=one, rt_tau=zero, lt=one, lt_tau=zero,
        pt=one, pt_tau=zero, pt_isbp=zero, pt_tab=zi,
        pt_wl=zero, pt_wr=zero,
        op_tuples=tup, b12_tuples=tup,
        ep_tuples=np.array([[0, 0, 0, 0]], dtype=np.int64),
        end_states=np.array([0, 0, 0]),
        tid_r=np.array([0]), tid_l=np.array([0]),
        ws_r=np.zeros(1, bool), ws_l=np.zeros(1, bool),
        n_pair_tables=0,
        pair_table_index=np.array([-1]),
        single_table_index=np.array([0]),
    )


def dump(g: Grammar) -> str:
    """Text dump comparable to ProfileHMM::save (profile_hmm.hpp:465-478)."""
    out = []
    for sid in range(g.S):
        out.append(f"{sid}: {g.state_l[sid]} {g.state_r[sid]}")
        for s1 in np.nonzero(g.rt[sid])[0]:
            out.append(f"\tright: {g.state_l[s1]} {g.state_r[s1]} {s1}")
        # reference prints loop_left_trans[sid] = sources keyed by sid
        for s in np.nonzero(g.lt[sid])[0]:
            out.append(f"\tleft: {g.state_l[s]} {g.state_r[s]} {s}")
        for s1 in np.nonzero(g.pt[sid])[0]:
            out.append(f"\tpair: {g.state_l[s1]} {g.state_r[s1]} {s1}")
    return "\n".join(out)
