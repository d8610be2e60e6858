"""Band-tile sharding with halo exchange (the stencil analogue of
sequence/context parallelism — SURVEY §5 'Long-context' row).

The genome axis of each band tensor is sharded into column tiles across a
1-D device mesh.  The widening ring scan is a +-maxww stencil whose line
accumulators reach a further +-maxww, so each tile needs a ``2*maxww``
halo from each neighbour.  The halo moves once per pass via
``jax.lax.ppermute`` (device-to-device links, non-periodic: edge
tiles receive ppermute's zero fill, which is exactly the reference's
zero padding at chromosome ends, callers.py:53-54).  Freeze counts are
``psum``-reduced so the controller's early-stop emulation sees global
numbers; everything downstream (scoring, BH sort) runs under jit on the
sharded arrays with XLA inserting the collectives.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from jax import shard_map
from ..ops import scan as scan_ops

HALO_AXIS = 'tiles'


def shard_band(arr, mesh):
    """Place a [num, L] band on the mesh, sharded along columns (pads the
    column count to a multiple of the mesh size)."""
    n = mesh.devices.size
    Lp = arr.shape[1]
    rem = (-Lp) % n
    if rem:
        arr = jnp.pad(jnp.asarray(arr), ((0, 0), (0, rem)))
    return jax.device_put(jnp.asarray(arr), NamedSharding(mesh, P(None, HALO_AXIS)))


def _with_halo(x, H, n):
    """Attach H columns of left/right-neighbour data (zeros at the ends)."""
    if n == 1:
        pad = jnp.zeros((x.shape[0], H), x.dtype)
        return jnp.concatenate([pad, x, pad], axis=1)
    left = jax.lax.ppermute(x[:, -H:], HALO_AXIS,
                            [(i, i + 1) for i in range(n - 1)])
    right = jax.lax.ppermute(x[:, :H], HALO_AXIS,
                             [(i, i - 1) for i in range(1, n)])
    return jnp.concatenate([left, x, right], axis=1)


def _zero_halo(x, H):
    pad = jnp.zeros((x.shape[0], H), x.dtype)
    return jnp.concatenate([pad, x, pad], axis=1)


def ir_sharded(raw, w0, nanw, L, ww_min, num, mesh):
    """Per-diagonal NaN-aware means (ops/band.build_bands' ``IR``) computed
    from the tile-sharded raw slab with one ``psum`` — the reduction that
    lets a multi-host run ingest band columns per host instead of building
    whole-chromosome bands on the controller (SURVEY §2.6's distance-
    expected, reference worker `scripts/pyHICCUPS:146-166`).

    Semantics pinned to the host builder: the balanced diagonal sum counts
    structural zeros in the denominator, subtracts only *nonzero* pixels
    whose weight product is NaN (zero weights stay in the denominator),
    divides with IEEE propagation (0/0 -> nan like numpy's errstate path),
    and zeroes rows ``< ww_min`` and ``>= num``.

    ``raw`` is sharded ``P(None, 'tiles')``; ``w0``/``nanw`` are the O(L)
    replicated vectors, padded to ``raw.shape[1]``.  Returns a replicated
    [num_p] vector in ``w0.dtype``.
    """
    num_p, Lp = raw.shape
    w0 = jnp.asarray(w0)
    nanw = jnp.asarray(nanw)
    if w0.shape[0] < Lp:
        w0 = jnp.pad(w0, (0, Lp - w0.shape[0]))
        nanw = jnp.pad(nanw, (0, Lp - nanw.shape[0]))
    return _ir_sharded_fn(int(num_p), int(L), int(ww_min), int(num),
                          mesh)(raw, w0, nanw)


@functools.lru_cache(maxsize=64)
def _ir_sharded_fn(num_p, L, ww_min, num, mesh):
    # jit cached per (shape, mesh): a fresh jax.jit wrapper per call
    # re-traces and re-compiles every invocation (_pass_a_sharded_fn)
    from ..ops.score import shear_bcast

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P(None, HALO_AXIS), P(), P()),
                       out_specs=P(),
                       check_vma=False)
    def run(raw_l, w0_g, nanw_g):
        T = raw_l.shape[1]
        c0 = jax.lax.axis_index(HALO_AXIS) * T
        # local slice [c0, c0+T+num_p) of each replicated vector: column i
        # needs w[c0+i] and w[c0+i+d] for d < num_p
        wsl = jax.lax.dynamic_slice(
            jnp.concatenate([w0_g, jnp.zeros(num_p, w0_g.dtype)]),
            (c0,), (T + num_p,))
        nsl = jax.lax.dynamic_slice(
            jnp.concatenate([nanw_g, jnp.zeros(num_p, nanw_g.dtype)]),
            (c0,), (T + num_p,))
        wxd = shear_bcast(wsl, num_p)[:, :T]        # w[c0+i+d]
        nxd = shear_bcast(nsl, num_p)[:, :T]
        rawf = raw_l.astype(w0_g.dtype)
        cb = rawf * wsl[None, :T] * wxd
        nanmask = (raw_l != 0) & (nsl[None, :T] | nxd)
        csum = jax.lax.psum(cb.sum(axis=1), HALO_AXIS)
        nancnt = jax.lax.psum(nanmask.sum(axis=1), HALO_AXIS)
        d = jnp.arange(num_p)
        denom = jnp.maximum(L - d, 0).astype(csum.dtype) - nancnt
        IR = csum / denom
        return jnp.where((d < ww_min) | (d >= num), 0.0, IR)

    return jax.jit(run)


def chunk_hist_sharded(O, cid, valid, S, C, mesh):
    """Exact int32 [S, C] (chunk, count) histogram of a column-sharded
    sheet: per-shard pack + histogram (ops/score.chunk_hist) inside
    shard_map + one psum.  Order-independent, so shard-local packing
    changes nothing; per-shard padding folds into the (0, 0) trash cell
    like the single-device pack."""
    from ..ops import score as score_ops

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P(None, HALO_AXIS),) * 3,
                       out_specs=P(),
                       check_vma=False)
    def run(O_l, cid_l, valid_l):
        Oc_p, cid_p, _n = score_ops._chunk_pack(O_l, cid_l, valid_l, S, C)
        h = score_ops.chunk_hist(Oc_p, cid_p, S, C)
        return jax.lax.psum(h, HALO_AXIS)

    return run(O, cid, valid)


@functools.lru_cache(maxsize=64)
def _pass_a_sharded_fn(plan, p_list, thr, mesh):
    """Build-and-jit once per (plan, mesh): a fresh ``jax.jit`` wrapper
    per call re-traces AND re-compiles every invocation."""
    n = mesh.devices.size
    H = 2 * max(e.w for e in plan)

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P(None, HALO_AXIS), P(None, HALO_AXIS)),
                       out_specs=P(),
                       check_vma=False)
    def run(raw_l, cand_l):
        raw_e = _with_halo(raw_l, H, n)
        cand_e = _zero_halo(cand_l, H)   # halo pixels belong to neighbours
        allowed = jnp.ones(len(plan), bool)
        counts = scan_ops._scan(raw_e, None, None, cand_e, plan, p_list,
                                thr, allowed, False)
        return jax.lax.psum(counts, HALO_AXIS)

    return jax.jit(run)


def scan_pass_a_sharded(raw, cand_mask, plan, p_list, thr, mesh):
    """Sharded freeze-count pass; returns globally psum-reduced counts.
    The ring scan runs on each device's halo-extended local slab inside
    shard_map."""
    return _pass_a_sharded_fn(tuple(plan), tuple(p_list), int(thr),
                              mesh)(raw, cand_mask)


@functools.lru_cache(maxsize=64)
def _pass_b_sharded_fn(plan, p_list, thr, mesh):
    """Once-per-(plan, mesh) jitted sharded capture pass (see
    :func:`_pass_a_sharded_fn` for why the jit must be cached)."""
    n = mesh.devices.size
    H = 2 * max(e.w for e in plan)
    band_spec = P(None, HALO_AXIS)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(band_spec, band_spec, band_spec, band_spec, P()),
        out_specs=(P(), {p: band_spec for p in p_list},
                   {p: [band_spec] * 4 for p in p_list}),
        check_vma=False)
    def run(raw_l, cband_l, eband_l, cand_l, allowed_l):
        raw_e = _with_halo(raw_l, H, n)
        cband_e = _with_halo(cband_l, H, n)
        eband_e = _with_halo(eband_l, H, n)
        cand_e = _zero_halo(cand_l, H)
        counts, captured, outs = scan_ops._scan(
            raw_e, cband_e, eband_e, cand_e, plan, p_list, thr, allowed_l,
            True)
        crop = lambda a: a[:, H:-H]
        captured = {p: crop(v) for p, v in captured.items()}
        outs = {p: [crop(v) for v in o] for p, o in outs.items()}
        return jax.lax.psum(counts, HALO_AXIS), captured, outs

    return jax.jit(run)


def scan_pass_b_sharded(raw, cband, eband, cand_mask, allowed, plan, p_list,
                        thr, mesh):
    """Sharded capture pass; capture tensors come back sharded along
    tiles.  Returns (counts, captured, outs) like ops/scan.scan_pass_b."""
    return _pass_b_sharded_fn(tuple(plan), tuple(p_list), int(thr),
                              mesh)(raw, cband, eband, cand_mask, allowed)
