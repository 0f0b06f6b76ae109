"""Training objective: discriminative EM function/gradient evaluation.

Replicates RNAelemTrainDP::operator() (motif_trainer.hpp:124-272):

* default mode: f += Z(all) - Z(label-restricted); positives (has-motif
  sentinel) restrict to motif-present (ari), negatives/unflagged restrict
  to motif-absent (nasi);
* lik-ratio mode (TR_LIK_RATIO): f += +-(Z(motif) - Z(all)) with sign -1
  for flagged positives;
* reads whose partition functions are non-finite contribute nothing
  (motif_trainer.hpp:211-214);
* gradients of f w.r.t. theta/s and lambda are the reference's
  ENo-ENx / EHo-EHx expected-count differences, obtained here by
  jax.grad through the DP's custom VJP.

Batched over padded same-length-bucket reads with vmap; the per-step
all-reduce for multi-host data parallelism lives in parallel/mesh.py.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..model import joint as J
from ..ops.semiring import NEG, lse


class BatchData(NamedTuple):
    sd: J.SeqData            # fields stacked with leading batch axis
    restrict_ari: jnp.ndarray  # [B] bool: label-restriction is motif-present
    lik_sign: jnp.ndarray    # [B] +-1.0 for lik-ratio mode
    is_neg: jnp.ndarray      # [B] bool: shuffled negative (weaker skip
    #                           check, motif_trainer.hpp:236)
    valid: jnp.ndarray       # [B] bool (padding rows in a batch)
    bp_ok: jnp.ndarray       # [B, Lp+1, Wp+1] min-BPP pruning masks —
    #   parameter-independent, so computed once per sequence instead of
    #   per evaluation (the reference recomputes them every visit,
    #   energy_model.hpp:268-276; identical semantics, ~2x cheaper)
    eff: jnp.ndarray         # [B] bpp_eff per read


class BpMaskCache:
    """Bounded LRU for min-BPP pruning masks keyed by (Lp, seq bytes).

    The reference recomputes the masks at every visit
    (energy_model.hpp:268-276); caching them is this framework's
    improvement, so the cache owns its memory story: entries are
    evicted least-recently-used once the byte total exceeds the cap
    (default 256 MB, RNAELEM_BP_CACHE_MB)."""

    def __init__(self, max_bytes: int = None):
        import os
        from collections import OrderedDict
        if max_bytes is None:
            max_bytes = int(os.environ.get(
                "RNAELEM_BP_CACHE_MB", "256")) << 20
        self.max_bytes = max_bytes
        self._d = OrderedDict()
        self._bytes = 0

    @staticmethod
    def _size(v):
        bp, _ = v
        return bp.nbytes + 64

    def __contains__(self, k):
        return k in self._d

    def __len__(self):
        return len(self._d)

    def __getitem__(self, k):
        self._d.move_to_end(k)
        return self._d[k]

    def __setitem__(self, k, v):
        if k in self._d:
            self._bytes -= self._size(self._d[k])
        self._d[k] = v
        self._d.move_to_end(k)
        self._bytes += self._size(v)
        while self._bytes > self.max_bytes and len(self._d) > 1:
            _, old = self._d.popitem(last=False)
            self._bytes -= self._size(old)


def stack_reads(cfg: J.ModelConfig, reads, negatives=None,
                bp_cache: dict = None, bp_fn=None) -> BatchData:
    """Host-side: pack reads (+ optional shuffled negatives) into a batch.

    reads: list of (seq_codes, quals) tuples. negatives: list of
    seq_codes (quality all zero, restricted to motif-absent,
    motif_trainer.hpp:228-245).  bp_cache (optional, mutated): maps
    sequence content bytes -> (bp_ok, eff); pruning masks are
    parameter-independent so positives need them computed only once.
    """
    sds, ari, sign, neg, keys = [], [], [], [], []
    for seq, quals in reads:
        sd = J.make_seqdata(cfg, seq, quals)
        sds.append(sd)
        ari.append(bool(sd.has_motif))
        sign.append(-1.0 if bool(sd.has_motif) else 1.0)
        neg.append(False)
        # mask shapes depend on the length bucket -> key by (Lp, bytes)
        keys.append((cfg.Lp, np.asarray(seq).tobytes()))
    for seq in negatives or []:
        q = np.zeros(len(seq) + 1, np.int64)
        sds.append(J.make_seqdata(cfg, seq, q))
        ari.append(False)
        sign.append(1.0)
        neg.append(True)
        keys.append(None)
    # one host-side np.stack + one device transfer PER FIELD (SeqData
    # rows are host arrays) instead of a device-side 128-operand
    # jnp.stack, which compiles once per batch shape
    sd = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *sds)
    if bp_fn is None:
        bp_fn = batch_bp_masks

    if bp_cache is None:
        bp_ok, eff = bp_fn(cfg, sd)
    else:
        miss = [i for i, k in enumerate(keys)
                if k is None or k not in bp_cache]
        Lp, Wp = cfg.Lp, cfg.Wp
        bp_np = np.zeros((len(sds), Lp + 1, Wp + 1), bool)
        eff_np = np.zeros(len(sds))
        if miss:
            sub = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)),
                               *[sds[i] for i in miss])
            mb, me = bp_fn(cfg, sub)
            mb, me = np.asarray(mb), np.asarray(me)
            for t, i in enumerate(miss):
                bp_np[i], eff_np[i] = mb[t], me[t]
                if keys[i] is not None:
                    bp_cache[keys[i]] = (mb[t], float(me[t]))
        for i, k in enumerate(keys):
            if k is not None and k in bp_cache and i not in miss:
                bp_np[i], eff_np[i] = bp_cache[k]
        bp_ok, eff = jnp.asarray(bp_np), jnp.asarray(eff_np)

    return BatchData(
        sd=sd,
        restrict_ari=jnp.asarray(ari),
        lik_sign=jnp.asarray(sign, jnp.dtype(cfg.dtype)),
        is_neg=jnp.asarray(neg),
        valid=jnp.ones(len(sds), bool),
        bp_ok=bp_ok,
        eff=eff,
    )


def batch_bp_masks(cfg: J.ModelConfig, sd_batch):
    """Vectorized min-BPP pruning masks for a stacked SeqData batch."""
    J.kernels(cfg)
    return J._effective_bp_mask_batch_jit(cfg, sd_batch)


def batch_total(cfg: J.ModelConfig, params: J.Params, batch: BatchData,
                lik_ratio: bool):
    """(sum f, sum eff) over the batch through the batched DP.

    Per-read objective terms and skip rules follow
    motif_trainer.hpp:156-245: default mode f += Z(all) - Z(restricted);
    lik-ratio mode f += sign * (Z(motif) - Z(all)); reads with a
    non-finite partition function contribute nothing."""
    parts = J._batch_logZ_parts_jit(cfg, params, batch.sd, None,
                                    batch.bp_ok)        # [B, 3]
    f, eff = _per_read_terms(cfg, parts, batch, lik_ratio)
    return f.sum(), eff.sum()


@functools.partial(jax.jit, static_argnums=(0, 3))
def batch_fn_grad(cfg: J.ModelConfig, params: J.Params, batch: BatchData,
                  lik_ratio: bool = False):
    """(fn, grads, sum_eff) over a batch; grads is a Params pytree."""

    def total(p):
        return batch_total(cfg, p, batch, lik_ratio)

    (fn, eff), grads = jax.value_and_grad(total, has_aux=True)(params)
    return fn, grads, eff


def _per_read_terms(cfg, parts, batch: BatchData, lik_ratio: bool):
    """Per-read objective terms f[B] / eff[B] (motif_trainer.hpp:156-245;
    same math as batch_total without the reduction)."""
    z_all = lse(parts, axis=-1)
    z_ari = lse(jnp.where(jnp.asarray([False, True, True])[None],
                          parts, NEG), axis=-1)
    z_nasi = parts[:, 0]
    if lik_ratio:
        f = batch.lik_sign * (z_ari - z_all)
        ok = jnp.isfinite(z_all) & jnp.isfinite(z_ari)
    else:
        z_restr = jnp.where(batch.restrict_ari, z_ari, z_nasi)
        f = z_all - z_restr
        ok = jnp.isfinite(z_all) & (batch.is_neg | jnp.isfinite(z_ari))
    f = jnp.where(ok & batch.valid, f, 0.0)
    eff = jnp.where(batch.valid & ~batch.is_neg, batch.eff, 0.0)
    return f, eff


def per_read_core(cfg: J.ModelConfig, params: J.Params, batch: BatchData,
                  lik_ratio: bool = False):
    """(f[B], per-read grads pytree with leading B, eff[B]).

    Parameters are broadcast into per-read copies before the DP, so the
    VJP seeded with ones yields exactly d f_b / d params per read (f_b
    depends only on row b of the broadcast).  Shard-count-invariant by
    construction: the device never sums across reads, the caller
    reduces in read order (reduce_per_read)."""
    B = batch.valid.shape[0]
    params_b = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (B,) + x.shape), params)

    def f_of(pb):
        parts = J._batch_logZ_parts_pr_jit(cfg, pb, batch.sd,
                                           batch.bp_ok)
        f, eff = _per_read_terms(cfg, parts, batch, lik_ratio)
        return f, eff

    f, vjp, eff = jax.vjp(f_of, params_b, has_aux=True)
    (grads_b,) = vjp(jnp.ones_like(f))
    return f, grads_b, eff


@functools.partial(jax.jit, static_argnums=(0, 3))
def batch_fn_grad_pr(cfg: J.ModelConfig, params: J.Params,
                     batch: BatchData, lik_ratio: bool = False):
    return per_read_core(cfg, params, batch, lik_ratio)


def reduce_per_read(f_b, grads_b, eff_b):
    """Canonical read-order reduction on host (f64 numpy): the same
    bits regardless of how the batch was sharded across devices."""
    fn = float(np.add.reduce(np.asarray(f_b, np.float64), axis=0))
    eff = float(np.add.reduce(np.asarray(eff_b, np.float64), axis=0))
    grads = jax.tree.map(
        lambda x: np.add.reduce(np.asarray(x, np.float64), axis=0),
        grads_b)
    return fn, grads, eff


def assigned_range(N: int, n: int, tid: int):
    """Balanced contiguous slice for distributed eval slaves
    (arrayjob_manager.hpp:143-151); tid is 0-based here."""
    base, rem = divmod(N, n)
    start = tid * base + min(tid, rem)
    return start, start + base + (1 if tid < rem else 0)


def eval_file(cfg: J.ModelConfig, params: J.Params, fq_path: str,
              lik_ratio: bool = False, batch_size: int = 0,
              shard=None):
    """Full-file fn/gr evaluation (motif_eval.hpp:23-54, no-shuffle).

    shard=(tid, n) restricts to the tid-th of n contiguous slices (the
    array-eval slave path).  Returns (fn, flat_grad, sum_eff).
    """
    from ..io.fastq import FastqReader
    qr = FastqReader(fq_path)
    reads = [(r.seq, r.qual) for r in qr.reads()]
    if shard is not None:
        lo, hi = assigned_range(len(reads), shard[1], shard[0])
        reads = reads[lo:hi]
    g = J.kernels(cfg).g
    fn_total, eff_total = 0.0, 0.0
    acc = None
    bs = batch_size or len(reads)
    for k in range(0, len(reads), bs):
        batch = stack_reads(cfg, reads[k:k + bs])
        fn, grads, eff = batch_fn_grad(cfg, params, batch, lik_ratio)
        fn_total += float(fn)
        eff_total += float(eff)
        if acc is None:
            acc = grads
        else:
            acc = jax.tree.map(jnp.add, acc, grads)
    flat = J.pack_params(g, acc)
    return fn_total, flat, eff_total
