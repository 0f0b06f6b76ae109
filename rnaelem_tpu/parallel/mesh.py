"""Multi-device / multi-host data parallelism over a jax.sharding.Mesh.

The reference's distributed objective evaluation (TR_ARRAY,
motif_trainer.hpp:608-614 + motif_array_trainer.hpp) broadcasts the model
through a file, slices the FASTQ across SGE array tasks and sums
fn/gr/eff from text files.  Here the read batch is sharded over the
mesh's flat 'data' axis (one entry per device), parameters are
replicated, and the per-read results are gathered and summed on the host
in read order — one jitted step, no filesystem.

Multi-host: call jax.distributed.initialize() first; the mesh then spans
non-addressable devices, so input staging switches from device_put to
jax.make_array_from_process_local_data (every host builds the identical
global batch from the shared FASTQ — the reference's shared-filesystem
contract, arrayjob_manager.hpp:121-151 — and JAX ships each host only
its own shard), and per-read outputs come back through a host-side
allgather so the read-order reduction stays byte-identical on every
process (tests/test_multiprocess.py runs this with 2 local CPU
processes).
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..model import joint as J
from ..train import objective as OBJ


def data_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), ("data",))


def _fully_addressable(mesh: Mesh) -> bool:
    pi = jax.process_index()
    return all(d.process_index == pi for d in mesh.devices.flat)


def _stage(tree, mesh: Mesh, spec):
    """Place a host pytree onto the mesh with one PartitionSpec for all
    leaves.  Single-process: plain device_put.  Multi-process: every
    host holds the full array (identical bytes by construction);
    make_array_from_process_local_data slices out this host's shards and
    assembles the global jax.Array without any cross-host transfer."""
    sh = NamedSharding(mesh, spec)
    if _fully_addressable(mesh):
        return jax.tree.map(lambda x: jax.device_put(x, sh), tree)
    return jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(
            sh, np.asarray(x), global_shape=np.asarray(x).shape), tree)


def _collect(tree, mesh: Mesh):
    """Bring a 'data'-sharded device pytree fully back to every host.
    Multi-process: local shards -> host numpy -> process allgather in
    process order, which reconstructs the global batch order (the mesh
    is built from jax.devices(), sorted by process)."""
    if _fully_addressable(mesh):
        return jax.tree.map(np.asarray, tree)
    from jax.experimental import multihost_utils as mh

    def one(x):
        loc = mh.global_array_to_host_local_array(x, mesh, P("data"))
        return mh.process_allgather(np.asarray(loc), tiled=True)

    return jax.tree.map(one, tree)


def _local_total(cfg, lik_ratio, p, batch):
    return OBJ.batch_total(cfg, p, batch, lik_ratio)


def make_sharded_fn_grad(cfg: J.ModelConfig, mesh: Mesh,
                         lik_ratio: bool = False):
    """Returns step(params, batch) -> (fn, grads, eff), with the batch
    sharded over mesh axis 'data' and gradients psum-reduced."""
    J.kernels(cfg)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), jax.tree.map(lambda _: P("data"), _batch_spec())),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    def step(params, batch):
        def total(p):
            return _local_total(cfg, lik_ratio, p, batch)

        (fn, eff), grads = jax.value_and_grad(
            total, has_aux=True)(params)
        fn = jax.lax.psum(fn, "data")
        eff = jax.lax.psum(eff, "data")
        grads = jax.tree.map(lambda g: jax.lax.psum(g, "data"), grads)
        return fn, grads, eff

    step_jit = jax.jit(step)  # traced once per batch shape, not per call

    def run(params, batch: OBJ.BatchData):
        nd = mesh.devices.size
        batch = pad_batch(batch, nd)
        batch = _stage(batch, mesh, P("data"))
        params = _stage(params, mesh, P())
        fn, grads, eff = step_jit(params, batch)
        # psum-reduced outputs are replicated; any addressable shard is
        # the full value
        return (np.asarray(jax.device_get(fn)),
                jax.tree.map(lambda g: np.asarray(jax.device_get(g)),
                             grads),
                np.asarray(jax.device_get(eff)))

    return run


def _batch_spec():
    # structural template for in_specs over BatchData
    return OBJ.BatchData(
        sd=J.SeqData(seq=0, ws=0, L=0, has_motif=0, rss_pair=0, dots=0),
        restrict_ari=0, lik_sign=0, is_neg=0, valid=0, bp_ok=0, eff=0)


def make_sharded_per_read(cfg: J.ModelConfig, mesh: Mesh,
                          lik_ratio: bool = False):
    """The production multi-chip training step (the reference's TR_ARRAY
    loop, motif_trainer.hpp:608-614 + motif_eval.hpp:23-54, as one SPMD
    program): returns step(params, batch) -> (f[B], per-read grads,
    eff[B]) with the batch sharded over the 'data' axis and NO device
    reduction — the caller reduces in read order (objective.
    reduce_per_read), which is bit-identical to the single-device path."""
    J.kernels(cfg)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), jax.tree.map(lambda _: P("data"), _batch_spec())),
        out_specs=P("data"),
        check_vma=False,
    )
    def step(params, batch):
        return OBJ.per_read_core(cfg, params, batch, lik_ratio)

    step_jit = jax.jit(step)

    def run(params, batch: OBJ.BatchData):
        nd = mesh.devices.size
        n = batch.valid.shape[0]
        batch = pad_batch(batch, nd)
        batch = _stage(batch, mesh, P("data"))
        params = _stage(params, mesh, P())
        f, grads_b, eff = _collect(step_jit(params, batch), mesh)
        trim = lambda x: x[:n]
        return trim(f), jax.tree.map(trim, grads_b), trim(eff)

    return run


def make_sharded_bp_masks(cfg: J.ModelConfig, mesh: Mesh):
    """Sharded min-BPP pruning pass (energy_model.hpp:211-266): the
    motif-free inside+VJP runs data-parallel over the mesh."""
    J.kernels(cfg)
    sd_spec = J.SeqData(seq=0, ws=0, L=0, has_motif=0, rss_pair=0, dots=0)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(jax.tree.map(lambda _: P("data"), sd_spec),),
        out_specs=(P("data"), P("data")),
        check_vma=False,
    )
    def bp(sd_b):
        return J._effective_bp_mask_batch_jit(cfg, sd_b)

    bp_jit = jax.jit(bp)

    def run(cfg_, sd_b):
        # the sharded bp kernel is specialized on the construction-time
        # cfg; a different bucket cfg would silently get wrong shapes
        assert cfg_ == cfg, "make_sharded_bp_masks: cfg mismatch"
        nd = mesh.devices.size
        n = int(sd_b.L.shape[0])
        npad = (-n) % nd
        if npad:
            def padf(x):
                pw = [(0, npad)] + [(0, 0)] * (x.ndim - 1)
                return jnp.pad(x, pw)
            sd_b = jax.tree.map(padf, sd_b)
            sd_b = sd_b._replace(L=sd_b.L.at[n:].set(1))
        sd_b = _stage(sd_b, mesh, P("data"))
        keep, eff = _collect(bp_jit(sd_b), mesh)
        return keep[:n], eff[:n]

    return run


def pad_batch(batch: OBJ.BatchData, multiple: int) -> OBJ.BatchData:
    """Pad the batch axis to a multiple of the device count with invalid
    rows (masked out of fn/grad)."""
    n = batch.valid.shape[0]
    npad = (-n) % multiple
    if npad == 0:
        return batch

    def pad(x):
        pw = [(0, npad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, pw)

    out = jax.tree.map(pad, batch)
    valid = out.valid.at[n:].set(False)
    # keep padded rows parseable (L=1) so the DP stays NaN-free
    L = out.sd.L.at[n:].set(1)
    return out._replace(valid=valid, sd=out.sd._replace(L=L))
