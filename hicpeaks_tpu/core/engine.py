"""Per-chromosome peak-calling engines (device compute + controller glue).

The device phases (ring scan, expected values, Poisson/lambda-chunk/BH,
gap filter) produce dense reject masks; the small surviving candidate set
moves to the controller for the reference's set-logic post-processing
(background combination, fold gates, cross-parameter merge, greedy
clustering — callers.py:319-362/579-590)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from ..ops import scan as scan_ops
from ..ops import score as score_ops
from ..ops.band import ChromBands
from . import poolplan
from .clustering import local_clustering
from .config import BHFDRConfig, HiccupsConfig


class _SlabEnc(NamedTuple):
    """Row-classed lossless slab transfer encoding: ``parts[i]`` carries a
    contiguous row range packed at ``bits[i]`` bits per count (16/8 are
    plain uint16/uint8 rows; 4/2 pack 2/4 adjacent columns per byte)."""
    parts: tuple
    bits: tuple


_SLAB_WIDTHS = (16, 8, 4, 2)


def _pack_rows(rows, bits):
    """Pack uint16 count rows at ``bits`` bits per count (lossless for
    counts < 2**bits).  Byte j of a packed row holds original columns
    j*per + k at bit offset bits*k (k < per = 8//bits) — the exact
    inverse of ops/score._unpack_rows' shift/mask/stack."""
    if bits == 16:
        return np.ascontiguousarray(rows)
    if bits == 8:
        return rows.astype(np.uint8)
    per = 8 // bits
    a = rows.astype(np.uint8)
    out = np.zeros((a.shape[0], a.shape[1] // per), np.uint8)
    for k in range(per):
        out |= a[:, k::per] << (bits * k)
    return out


def _compact_slab(bands: ChromBands, split=True):
    """The raw slab in its cheapest lossless transfer encoding.

    * integer counts < 65536 round-trip (checked), else the float slab
      ships as-is;
    * Hi-C counts fall off steeply with genomic distance, so the deep
      rows of a band never reach 256/16/4: rows are classed into uint16 /
      uint8 / 4-bit / 2-bit ranges at 64-row-bucketed boundaries
      (bounding the compile count) and sub-byte ranges pack 2 or 4
      columns per byte — the slab is the one dense host→device transfer
      per chromosome, and the far rows of a genome-scale band are almost
      entirely 0/1/2 counts.

    ``split=True`` returns a :class:`_SlabEnc`; ``split=False`` (mesh /
    sharded callers, which need one contiguous array to scatter) returns
    the single-array u16/float form."""
    raw_host = bands.raw
    if raw_host.dtype.kind != 'f':
        return raw_host
    enc = getattr(bands, '_raw_enc', None)
    if enc is None:
        enc = False
        if raw_host.size and 0.0 <= float(raw_host.max()) < 65536.0:
            candidate = raw_host.astype(np.uint16)
            # round-trip equality rejects non-integral and negative
            # counts (both wrap/truncate), so integer transfer is lossless
            if np.array_equal(candidate.astype(raw_host.dtype), raw_host):
                rowmax = candidate.max(axis=1)
                n_rows = candidate.shape[0]
                cuts = []
                for b in _SLAB_WIDTHS[:-1]:   # boundary below each width
                    big = np.nonzero(rowmax >= (1 << _SLAB_WIDTHS[
                        _SLAB_WIDTHS.index(b) + 1]))[0]
                    d = int(big[-1]) + 1 if big.size else 0
                    cuts.append(min(-(-d // 64) * 64, n_rows))
                # prefer FIXED cut positions (a function of the row count
                # alone) whenever the data admits them: the cut tuple is
                # a static argument of the fused chromosome program, so
                # data-driven cuts compile one executable per chromosome
                # while fixed cuts share one across the genome (the
                # traced-L change makes that sharing real).  Fixed cuts
                # are valid iff each is >= the data-required boundary;
                # otherwise the exact data-driven cuts stand (losslessness
                # is never traded for sharing).
                ru64 = lambda v: min(-(-v // 64) * 64, n_rows)
                fixed = [min(64, n_rows), ru64(n_rows // 4),
                         ru64(n_rows // 2)]
                fixed = sorted(fixed)    # monotone for tiny row counts
                if all(f >= c for f, c in zip(fixed, cuts)):
                    cuts = fixed
                cuts = [0] + cuts + [n_rows]
                parts, bits = [], []
                for b, lo, hi in zip(_SLAB_WIDTHS, cuts[:-1], cuts[1:]):
                    if hi > lo:
                        parts.append(_pack_rows(candidate[lo:hi], b))
                        bits.append(b)
                enc = _SlabEnc(tuple(parts), tuple(bits))
        bands._raw_enc = enc
    if enc is False:
        return raw_host
    if not split:
        full = getattr(bands, '_raw_u16_full', None)
        if full is None:
            full = raw_host.astype(np.uint16)
            bands._raw_u16_full = full
        return full
    return enc


def _to_device_slab(enc):
    """Host slab encoding -> device form (_SlabEnc parts go up as-is)."""
    if isinstance(enc, _SlabEnc):
        return _SlabEnc(tuple(jnp.asarray(a) for a in enc.parts), enc.bits)
    return jnp.asarray(enc)


def _slab_args(enc):
    """(raw_operand, bits_static) for ops/score.build_sheets_device."""
    if isinstance(enc, _SlabEnc):
        return enc.parts, enc.bits
    return enc, None


def stage_chrom_arrays(bands: ChromBands):
    """Issue the chromosome's host→device transfers ahead of time.

    Called from the api.py prefetch thread right after the band build, so
    the slab+vector transfer (the largest remaining per-chromosome cost on
    hosts with slow links) overlaps the previous chromosome's device
    compute.  JAX transfers are async and thread-safe; the consumer picks
    the arrays up via ``bands._staged`` (single-device path only — mesh
    runs re-shard from host)."""
    bands._staged = dict(raw=_to_device_slab(_compact_slab(bands)),
                         w0=jnp.asarray(bands.w0),
                         bias=jnp.asarray(bands.bias),
                         IR=jnp.asarray(bands.IR),
                         gap=jnp.asarray(bands.gap))


def _staged_operands(bands: ChromBands):
    """(raw_op, bits, w0, bias, IR, gap) device operands for the fused
    single-program path, reusing the api.py prefetch staging when
    present (single-device path only)."""
    staged = getattr(bands, '_staged', None)
    if staged is None:
        stage_chrom_arrays(bands)
        staged = bands._staged
    raw_op, bits = _slab_args(staged['raw'])
    return (raw_op, bits, staged['w0'], staged['bias'], staged['IR'],
            staged['gap'])


def _prep_chrom(bands: ChromBands, d_lo, d_hi, gap_s, mesh=None,
                ir_backend='host'):
    """Transfer one raw slab + O(L) vectors, then derive every dense sheet
    (balanced band, expected band, bias product, gap-reject, candidate
    mask) on device in one jit (ops/score.build_sheets_device), instead
    of building the sheets on the host and shipping ~5 slabs per
    chromosome.  Integer count slabs < 65536 ship as uint16 (half the
    bytes of float32); the float32 slab is rebuilt on device."""
    staged = getattr(bands, '_staged', None)
    if staged is not None and mesh is None:
        # transfers were issued ahead of time (api.py prefetch thread) so
        # they overlapped the previous chromosome's device compute
        raw_op, bits = _slab_args(staged['raw'])
        raw, cband, eband, Bprod, gap_drop, cand = \
            score_ops.build_sheets_device(
                raw_op, staged['w0'], staged['bias'], staged['IR'],
                staged['gap'], bands.ww_min, bands.L, d_lo, d_hi, gap_s,
                bits=bits)
        return raw, cband, eband, staged['IR'], Bprod, gap_drop, cand
    if mesh is not None and hasattr(bands.raw, 'sharding'):
        # tile-sharded global array from parallel.multihost.
        # sharded_bands_from_cooler: each process scattered only its own
        # column tiles; IR/gap/vectors were reduced host-side already
        raw_sh = bands.raw
        raw_host = None
        if ir_backend == 'device':
            from ..parallel.tiles import ir_sharded
            IR = ir_sharded(raw_sh, jnp.asarray(bands.w0),
                            jnp.asarray(bands.nanw), bands.L, bands.ww_min,
                            bands.num, mesh)
        else:
            IR = jnp.asarray(bands.IR)
        raw, cband, eband, Bprod, gap_drop, cand = \
            score_ops.build_sheets_device(
                raw_sh, jnp.asarray(bands.w0), jnp.asarray(bands.bias), IR,
                jnp.asarray(bands.gap), bands.ww_min, bands.L, d_lo, d_hi,
                gap_s)
        from ..parallel.tiles import shard_band
        raw, cband, eband, Bprod, gap_drop, cand = (
            shard_band(a, mesh)
            for a in (raw, cband, eband, Bprod, gap_drop, cand))
        return raw, cband, eband, IR, Bprod, gap_drop, cand
    raw_host = _compact_slab(bands, split=mesh is None)
    if mesh is not None and ir_backend == 'device':
        # psum'd diagonal means from the sharded slab (parallel/tiles.
        # ir_sharded) — no controller reduction, the multi-host band-
        # ingestion reduction.  The raw slab lands sharded and is reused
        # below, so the transfer is not repeated.
        from ..parallel.tiles import ir_sharded, shard_band
        raw_sh = shard_band(jnp.asarray(raw_host), mesh)
        IR = ir_sharded(raw_sh, jnp.asarray(bands.w0),
                        jnp.asarray(bands.nanw), bands.L, bands.ww_min,
                        bands.num, mesh)
        if raw_sh.shape[1] != bands.w0.shape[0]:
            # shard_band padded the columns to the mesh size; rebuild the
            # sheets from the unpadded slab (rare: Lp is lane-padded to
            # 128, which every mesh here divides)
            raw_sh = None
    else:
        raw_sh = None
        IR = jnp.asarray(bands.IR)
    raw_op, bits = (_slab_args(_to_device_slab(raw_host))
                    if raw_sh is None else (raw_sh, None))
    raw, cband, eband, Bprod, gap_drop, cand = score_ops.build_sheets_device(
        raw_op, jnp.asarray(bands.w0), jnp.asarray(bands.bias), IR,
        jnp.asarray(bands.gap), bands.ww_min, bands.L, d_lo, d_hi, gap_s,
        bits=bits)
    if mesh is not None:
        from ..parallel.tiles import shard_band
        raw, cband, eband, Bprod, gap_drop, cand = (
            shard_band(a, mesh)
            for a in (raw, cband, eband, Bprod, gap_drop, cand))
    return raw, cband, eband, IR, Bprod, gap_drop, cand


import functools
import jax


@functools.partial(jax.jit, static_argnames=('wi', 'L', 'chunked', 'with_bh',
                                             'o_cap'))
def _score_device(raw, cband, IR, Bprod, bSV, bEV, cand, gap_drop, sig,
                  wi, L, chunked, with_bh=True, o_cap=None):
    """Jitted device half of background scoring (single compile per
    shape/config; no eager dispatch).  ``with_bh=False`` leaves the
    Benjamini-Hochberg correction to the host (ops/score.host_bh).
    For the chunked path, ``o_cap`` (>= the chromosome's max raw count)
    switches BH to the sort-free lambda-chunk histogram."""
    E, O, ICE, Fold, scored, prod = score_ops.expected_observed(
        raw, cband, IR, Bprod, bSV, bEV, wi, cand, L)
    if chunked:
        cid, rv, valid = score_ops.lambda_chunks(E, scored)
        pval = jnp.where(valid, score_ops.poisson_sf(O, rv), 1.0)
    else:
        cid = jnp.ones(E.shape, jnp.int32)
        valid = scored
        pval = jnp.where(scored, score_ops.poisson_sf(O, E), 1.0)
    if with_bh:
        if chunked and o_cap is not None:
            qval = score_ops.chunk_bh_histogram(O, cid, valid, o_cap=o_cap)
        else:
            qval = score_ops.segmented_bh(pval, cid, valid)
        reject = scored & (qval <= sig)
        keep = reject & ~gap_drop
    else:
        qval = None
        keep = None
    return pval, cid, valid, qval, keep, scored, O, ICE, Fold, prod, E


_KEEP_CAP = 1 << 17    # kept-pixel compaction hard bound (pre-clustering
                       # significant candidates are 1e2-1e5 in practice)
_KEEP_CAP_FAST = 1 << 13   # first-attempt cap: the compact search and the
                           # per-stat gathers scale with the cap, and
                           # pre-cluster significant
                           # pixels are 1e2-1e4 per chromosome in practice,
                           # and overflow just retries with the hard bound
                           # (one extra compile per shape bucket, cached)


_BH_SLACK = 0.01   # chunk_bh_keep superset inflation: covers the f32
                   # qtab's gammainc evaluation error near the q ~ sig
                   # boundary so the device keep mask is a superset of the
                   # float64 rejection set (ops/score.chunk_bh_keep)

_SUS_CAP = 1 << 15   # lambda-chunk edge suspects per background (fast
                     # tier; the hard-cap retry lifts it with keep_cap).
                     # At the provable margin (~7e-4 of pixels) a 25M-px
                     # genome chromosome carries ~18K suspects.


def _chunk_margin(plan):
    """Provable |t_f32 - t_f64| bound for t = 3*log2(E) (see
    ops/score.lambda_suspects): E's f32 relative error is bounded by the
    cancellation-free ring accumulation (<= cells nonneg adds per
    background sum, each cell itself a 2-product) plus the
    ratio/EM/Bprod arithmetic, dt = 3/ln2 * relE; the trailing pad covers
    the f32 log evaluation (~2 ulps at |t| <= 128)."""
    maxw = max(e.w for e in plan)
    cells = (2 * maxw + 1) ** 2
    return 3.0 / 0.6931471805599453 * (3 * cells + 8) * 2.0 ** -24 + 5e-5


def _compact_one(raw, cband, IR, Bprod, bSV, bEV, cand, gap_drop, sig, wi,
                 L, chunked, o_cap, keep_cap, mesh=None,
                 exact_mode=False, sus_cap=_SUS_CAP, margin=0.0,
                 s_rows=128):
    """Traced body shared by the single- and pair-background compact
    scorers.

    The histogram path (``o_cap`` set) returns NO device p/q at all: the
    device keeps a slightly inflated superset (``_BH_SLACK``) and ships the
    compacted (O, chunk) pairs plus the exact integer histogram; the
    controller finishes p/q in float64 and filters with the true ``sig``
    (ops/score.host_chunk_complete) — so the emitted statistics are the
    reference's float64 values, not f32 ``gammainc`` approximations (the
    round-2 verdict's 27%-relative tail drift).

    ``exact_mode`` (only meaningful with a host ExactCtx available)
    additionally compacts the lambda-chunk edge SUSPECTS — pixels whose
    f32 chunk membership is not provably the float64 one
    (ops/score.lambda_suspects, ``margin`` from :func:`_chunk_margin`) —
    excludes them from the device keep set, and ships their
    (d, x, cid, count, gap) so the controller can correct the integer
    histogram in float64 and decide their keep/stats exactly
    (the round-3 residual: a boundary pixel in the wrong chunk shifts
    that chunk's m/ranks by one, hence every q in it by ~1/m).

    Returns a 10-tuple; slot 9 is the suspect bundle (an empty tuple when
    ``exact_mode`` is off)."""
    E, O, ICE, Fold, scored, prod = score_ops.expected_observed(
        raw, cband, IR, Bprod, bSV, bEV, wi, cand, L)
    pval = qval = None
    sus_bundle = ()
    if chunked:
        cid, rv, valid = score_ops.lambda_chunks(E, scored)
        if o_cap is not None:
            # histogram BH decides `keep` from (chunk, count) alone via a
            # per-chunk count threshold, so neither the dense per-pixel
            # gammainc (iterative) nor the dense q-selection
            # matmul (S*pixels*o_cap f32 MACs — together the two largest
            # costs of the scoring program at genome scale) runs over the
            # full sheet; p/q for the <= keep_cap compacted pixels are
            # finished in float64 on the host from the histogram
            # split histogram on the fast tier only: the hard-cap retry
            # (and the mesh path) keep the unsplit exact kernel, so a
            # high-count-tail overflow lands in the same retry ladder as
            # a keep-cap overflow
            hist_hcap = (1 << 18) if keep_cap <= _KEEP_CAP_FAST else None
            keep_q, _qtab, hist, thr, h_ok = score_ops.chunk_bh_keep(
                O, cid, valid, sig, n_chunks=s_rows, o_cap=o_cap,
                slack=_BH_SLACK, mesh=mesh, hcap=hist_hcap)
        else:
            pval = jnp.where(valid, score_ops.poisson_sf(O, rv), 1.0)
            qval = score_ops.segmented_bh(pval, cid, valid)
    else:
        valid = scored
        pval = jnp.where(scored, score_ops.poisson_sf(O, E), 1.0)
        qval = score_ops.segmented_bh(pval, jnp.ones(E.shape, jnp.int32),
                                      valid)
    if qval is None:
        keep = scored & keep_q & ~gap_drop
        if exact_mode:
            sus = score_ops.lambda_suspects(E, scored, margin)
            keep = keep & ~sus
            cnt_s, d_s, x_s = score_ops.compact_mask(sus, sus_cap)
            gs = lambda a: a[d_s, x_s]
            cid_s = jnp.where(gs(valid), gs(cid), 0)
            O_s = jnp.clip(jnp.floor(gs(O)), 0, o_cap).astype(jnp.int32)
            sus_bundle = (cnt_s, d_s, x_s, cid_s, O_s, gs(gap_drop), thr)
    else:
        keep = scored & (qval <= sig) & ~gap_drop
    cnt, d_idx, x_idx = score_ops.compact_mask(keep, keep_cap)
    if qval is None:
        # an incomplete split histogram must not be consumed: report a
        # count past the cap so the controller retries at the hard tier
        cnt = jnp.where(h_ok, cnt, keep_cap + 1)
    g = lambda a: a[d_idx, x_idx]
    if pval is None:
        cid_g = jnp.where(g(valid), g(cid), 0)
        return (cnt, d_idx, x_idx,
                g(O), g(ICE), g(Fold), cid_g, hist, prod, sus_bundle)
    return (cnt, d_idx, x_idx,
            g(O), g(ICE), g(Fold), g(pval), g(qval), prod, sus_bundle)


@functools.partial(jax.jit, static_argnames=('wi', 'chunked', 'o_cap',
                                             'keep_cap', 'mesh', 'exact_mode',
                                             'sus_cap', 'margin', 's_rows'))
def _score_device_compact(raw, cband, IR, Bprod, bSV, bEV, cand, gap_drop,
                          sig, wi, L, chunked, o_cap=None,
                          keep_cap=_KEEP_CAP, mesh=None,
                          exact_mode=False, sus_cap=_SUS_CAP, margin=0.0,
                          s_rows=128):
    """Device-BH scoring that compacts the kept pixels on device.

    Dense [num_p, Lp] sheets never cross to the host (each is ~100MB+
    per background at genome scale): the keep mask is compacted to at
    most ``keep_cap`` (d, x) indices + per-pixel stats, a few MB total.
    The dense EM*ratio product stays resident on device for the hiccups
    postcheck, served by :func:`_gather_pairs`."""
    return _compact_one(raw, cband, IR, Bprod, bSV, bEV, cand, gap_drop,
                        sig, wi, L, chunked, o_cap, keep_cap,
                        mesh, exact_mode=exact_mode, sus_cap=sus_cap,
                        margin=margin, s_rows=s_rows)


@functools.partial(jax.jit, static_argnames=('wi', 'L', 'chunked', 'o_cap',
                                             'keep_cap'))
def _score_device_compact_checked(raw, cband, IR, Bprod, bSV, bEV, cand,
                                  gap_drop, sig, wi, L, chunked, o_cap=None,
                                  keep_cap=_KEEP_CAP):
    """checkify-instrumented twin of :func:`_score_device_compact`
    (SURVEY §5 'race detection / sanitizers' row): every float op is
    checked for NaN/inf production and every gather for OOB indices; the
    functional error value is fetched and thrown on the host.  Opt-in
    (``check=True`` on the chrom engines / ``--checkify`` on the CLIs)
    because the instrumentation costs throughput."""
    from jax.experimental import checkify

    def body(raw, cband, IR, Bprod, bSV, bEV, cand, gap_drop, sig):
        return _compact_one(raw, cband, IR, Bprod, bSV, bEV, cand,
                            gap_drop, sig, wi, L, chunked, o_cap, keep_cap)

    return checkify.checkify(
        body, errors=checkify.float_checks | checkify.index_checks)(
            raw, cband, IR, Bprod, bSV, bEV, cand, gap_drop, sig)


def _gather_flat_b(a, d, x):
    """Batched per-pixel gather a[b, d[b,k], x[b,k]] without vmap: one
    take_along_axis over the flattened sheet (vmap's batching rules emit
    costlier gather forms)."""
    B, _num_p, Lp = a.shape
    return jnp.take_along_axis(a.reshape(B, -1), d * Lp + x, axis=1)


def _gather_flat_shared(a, d, x):
    """Shared-sheet twin of :func:`_gather_flat_b`: a [num_p, Lp] indexed
    by batched [B, K] coordinates as one flat gather."""
    return a.reshape(-1)[d * a.shape[1] + x]


def _compact_batched(raw, cband, IR, Bprod, BSV, BEV, wis_t, cand, gap_drop,
                     sig, L, o_cap, keep_cap, exact_mode,
                     sus_cap, margin, s_rows=128):
    """All ``B`` backgrounds (every (p, w) pair x {K, Y}) scored in ONE
    batched body — the anti-unrolling form of the chunked scorer.

    A lax.scan over pairs is unrolled by XLA into one program copy per
    pair, so the generated code grows with the pair count.  Here the
    per-background elementwise stages broadcast over a leading [B] axis
    (ops/score.chunk_bh_keep_batched builds the B histograms with offset
    chunk rows), and the compactions / per-pixel gathers are batched ops
    instead of B copies.

    Semantics are _compact_one's, background by background: identical
    histograms (each background's pixels land in its own s_rows-row block
    with its own trash row b*s_rows), identical keep thresholds, identical
    compaction order.  Returns the 10-slot bundle with a leading [B]
    axis on every leaf (slot 8 = the dense EM*ratio product stacked
    [B, num_p, Lp]; slot 9 = the stacked suspect bundle or ())."""
    wi_b = wis_t[:, None, None]
    E, O, ICE, Fold, scored, prod = score_ops.expected_observed(
        raw, cband, IR, Bprod, BSV, BEV, wi_b, cand, L)
    B = E.shape[0]
    Ob = jnp.broadcast_to(O, E.shape)
    ICEb = jnp.broadcast_to(ICE, E.shape)
    cid, rv, valid = score_ops.lambda_chunks(E, scored)
    hist_hcap = (1 << 18) if keep_cap <= _KEEP_CAP_FAST else None
    keep_q, _qtab, hist, thr2, h_ok = score_ops.chunk_bh_keep_batched(
        Ob, cid, valid, sig, B, n_chunks=s_rows, o_cap=o_cap,
        slack=_BH_SLACK, hcap=hist_hcap)
    hist_b = hist.reshape(B, s_rows, o_cap + 1)
    keep = scored & keep_q & ~gap_drop
    sus_bundle = ()
    gb = _gather_flat_b                                   # per-bg sheet
    gu = _gather_flat_shared                              # shared sheet
    if exact_mode:
        sus = score_ops.lambda_suspects(E, scored, margin)
        keep = keep & ~sus
        cnt_s, d_s, x_s = score_ops.compact_mask_batched(sus, sus_cap)
        cid_s = jnp.where(gb(valid, d_s, x_s), gb(cid, d_s, x_s), 0)
        O_s = jnp.clip(jnp.floor(gu(O, d_s, x_s)), 0, o_cap) \
            .astype(jnp.int32)
        sus_bundle = (cnt_s, d_s, x_s, cid_s, O_s,
                      gu(gap_drop, d_s, x_s), thr2)
    cnt, d_idx, x_idx = score_ops.compact_mask_batched(keep, keep_cap)
    cnt = jnp.where(h_ok, cnt, keep_cap + 1)
    cid_g = jnp.where(gb(valid, d_idx, x_idx), gb(cid, d_idx, x_idx), 0)
    return (cnt, d_idx, x_idx,
            gb(Ob, d_idx, x_idx), gb(ICEb, d_idx, x_idx),
            gb(Fold, d_idx, x_idx), cid_g, hist_b, prod, sus_bundle)


def _bundle_slice(out, lo, hi):
    """Slice every leaf of a batched 10-slot bundle along its leading
    axis (slot 9 is a nested tuple or ())."""
    head = tuple(a[lo:hi] for a in out[:9])
    sus = tuple(a[lo:hi] for a in out[9]) if out[9] else ()
    return head + (sus,)


@functools.partial(jax.jit, static_argnames=('wi', 'chunked', 'o_cap',
                                             'keep_cap', 'mesh', 'exact_mode',
                                             'sus_cap', 'margin', 's_rows'))
def _score_device_compact_pair(raw, cband, IR, Bprod, KS, KE, YS, YE, cand,
                               gap_drop, sig, wi, L, chunked, o_cap=None,
                               keep_cap=_KEEP_CAP, mesh=None,
                               exact_mode=False, sus_cap=_SUS_CAP,
                               margin=0.0, s_rows=128):
    """Both backgrounds (donut 'K' and lower-left 'Y', callers.py:319-339)
    scored in ONE program with two explicit bodies."""
    outK = _compact_one(raw, cband, IR, Bprod, KS, KE, cand, gap_drop,
                        sig, wi, L, chunked, o_cap, keep_cap,
                        mesh, exact_mode=exact_mode, sus_cap=sus_cap,
                        margin=margin, s_rows=s_rows)
    outY = _compact_one(raw, cband, IR, Bprod, YS, YE, cand, gap_drop,
                        sig, wi, L, chunked, o_cap, keep_cap,
                        mesh, exact_mode=exact_mode, sus_cap=sus_cap,
                        margin=margin, s_rows=s_rows)
    return outK, outY


@functools.partial(jax.jit, static_argnames=('chunked', 'o_cap',
                                             'keep_cap', 'mesh', 'exact_mode',
                                             'sus_cap', 'margin', 's_rows'))
def _score_device_compact_multi(raw, cband, IR, Bprod, caps, cand, gap_drop,
                                sig, wis, L, chunked, o_cap=None,
                                keep_cap=_KEEP_CAP, mesh=None,
                                exact_mode=False, sus_cap=_SUS_CAP,
                                margin=0.0, s_rows=128):
    """Every (p, w) pair's two backgrounds scored in ONE program: the
    multi-parameter union (callers.py:132-232,345-349) costs a single
    dispatch + fetch round trip per chromosome.

    Off mesh, multi-pair and exact-mode configs route the 2*n_pairs
    backgrounds through the single BATCHED body
    (:func:`_compact_batched`; a scan over pairs unrolls into 2*n_pairs
    program copies); a non-exact single pair stays on the scanned
    two-call form.  Mesh callers always take the scanned form, whose
    per-shard histogram reduction is wired for a [128, C] table.

    Returns (outK, outY): each a 10-slot bundle with a leading n_pairs
    axis."""
    KS = jnp.stack([c[0] for c in caps])
    KE = jnp.stack([c[1] for c in caps])
    YS = jnp.stack([c[2] for c in caps])
    YE = jnp.stack([c[3] for c in caps])
    wis_t = jnp.asarray(wis, jnp.int32)
    n = len(caps)

    # batched body when it prevents >= 4-body unrolling, and for every
    # exact-mode (production) program regardless of pair count (smaller
    # executable, so a shorter cold compile)
    if mesh is None and chunked and o_cap is not None and \
            (n >= 2 or exact_mode):
        BSV = jnp.concatenate([KS, YS])
        BEV = jnp.concatenate([KE, YE])
        out = _compact_batched(raw, cband, IR, Bprod, BSV, BEV,
                               jnp.concatenate([wis_t, wis_t]), cand,
                               gap_drop, sig, L, o_cap, keep_cap,
                               exact_mode, sus_cap, margin, s_rows=s_rows)
        return _bundle_slice(out, 0, n), _bundle_slice(out, n, 2 * n)

    def body(_, xs):
        KSi, KEi, YSi, YEi, wi = xs
        outK = _compact_one(raw, cband, IR, Bprod, KSi, KEi, cand, gap_drop,
                            sig, wi, L, chunked, o_cap, keep_cap,
                            mesh, exact_mode=exact_mode,
                            sus_cap=sus_cap, margin=margin, s_rows=s_rows)
        outY = _compact_one(raw, cband, IR, Bprod, YSi, YEi, cand, gap_drop,
                            sig, wi, L, chunked, o_cap, keep_cap,
                            mesh, exact_mode=exact_mode,
                            sus_cap=sus_cap, margin=margin, s_rows=s_rows)
        return None, (outK, outY)

    _, (outK, outY) = jax.lax.scan(body, None, (KS, KE, YS, YE, wis_t))
    return outK, outY


def _fused_enabled():
    """Whether the one-program chromosome path may run.
    HICPEAKS_DISABLE_FUSED=1 forces the multi-dispatch ladder (benchmark
    decomposition knob: it is the same per-stage structure a mesh run
    uses, so sharded-vs-this isolates the actual collective/halo cost
    from the dispatch-structure cost, benchmarks/weak_scaling.py)."""
    import os
    return os.environ.get('HICPEAKS_DISABLE_FUSED') != '1'


def _sheets_and_passes(raw_op, w0, bias, IR, gap, ww_min, L, d_lo, d_hi,
                       gap_s, bits, plan, p_list, thr, gate):
    """The shared front of the one-program chromosome: device sheets,
    pass A, the traced freeze gate ``gate(counts)``, pass B.  Each stage's
    outputs are materialized (``optimization_barrier``) before the next
    stage reads them: otherwise XLA fuses the slab unpacking and the ring
    scan's shifted reads into the scorer's kernels, recomputing them and
    growing a few kernels so large that the chr1 program took minutes to
    compile.  Returns (sheets, counts, allowed, outs)."""
    sheets = jax.lax.optimization_barrier(score_ops.build_sheets_device(
        raw_op, w0, bias, IR, gap, ww_min, L, d_lo, d_hi, gap_s, bits=bits))
    raw, cband, eband, _, _, cand = sheets
    counts = scan_ops.scan_pass_a(raw, cand, plan, p_list, thr)
    allowed = gate(counts)
    outs = jax.lax.optimization_barrier(scan_ops.scan_pass_b(
        raw, cband, eband, cand, allowed, plan, p_list, thr)[2])
    return sheets, counts, allowed, outs


@functools.partial(jax.jit, static_argnames=(
    'plan', 'p_list', 'thr', 'ww_t', 'wis', 'ww_min', 'd_lo',
    'gap_s', 'o_cap', 'keep_cap', 'bits', 'exact_mode', 'sus_cap',
    'margin', 's_rows'))
def _fused_hiccups_device(raw_op, w0, bias, IR, gap, sig, total, t_left,
                          plan, p_list, thr, ww_t, wis, ww_min, L, d_lo,
                          d_hi, gap_s, o_cap, keep_cap, bits,
                          exact_mode=False, sus_cap=_SUS_CAP,
                          margin=0.0, s_rows=128):
    """The WHOLE per-chromosome hiccups device pipeline as ONE program:
    sheet derivation, freeze-count pass, the controller's early-stop
    bookkeeping (poolplan.device_allowed_hiccups — integer-exact, so it
    matches the host replay bit-for-bit), capture pass, and the fused
    multi-pair compact scorer.  One dispatch + one compacted fetch per
    chromosome instead of four round trips, which removes three blocking
    host synchronizations."""
    sheets, counts, allowed, outs = _sheets_and_passes(
        raw_op, w0, bias, IR, gap, ww_min, L, d_lo, d_hi, gap_s, bits, plan,
        p_list, thr, lambda c: poolplan.device_allowed_hiccups(
            c, total, t_left, plan, ww_t))
    raw, cband, _, Bprod, gap_drop, cand = sheets
    # ``wis`` is the static ((p, w), ...) pair list
    caps = tuple(tuple(outs[p]) for p, _ in wis)
    outK, outY = _score_device_compact_multi(
        raw, cband, IR, Bprod, caps, cand, gap_drop, sig,
        wis=tuple(w for _, w in wis), L=L, chunked=True,
        o_cap=o_cap, keep_cap=keep_cap,
        exact_mode=exact_mode, sus_cap=sus_cap, margin=margin,
        s_rows=s_rows)
    return counts, allowed, outK, outY


@functools.partial(jax.jit, static_argnames=(
    'plan', 'p_list', 'thr', 'wi', 'ww_min', 'd_lo', 'gap_s',
    'keep_cap', 'bits'))
def _fused_bhfdr_device(raw_op, w0, bias, IR, gap, sig, total, t_left,
                        plan, p_list, thr, wi, ww_min, L, d_lo, d_hi,
                        gap_s, keep_cap, bits):
    """bhfdr twin of :func:`_fused_hiccups_device`: sheets, pass A, the
    widening-loop break emulation (poolplan.device_allowed_bhfdr), pass B
    and the sort-free global-BH compact scorer in one dispatch."""
    sheets, counts, allowed, outs = _sheets_and_passes(
        raw_op, w0, bias, IR, gap, ww_min, L, d_lo, d_hi, gap_s, bits, plan,
        p_list, thr, lambda c: poolplan.device_allowed_bhfdr(
            c, total, t_left, plan))
    raw, cband, _, Bprod, gap_drop, cand = sheets
    KS, KE, _, _ = outs[p_list[0]]
    out = _score_device_bhfdr_compact(raw, cband, IR, Bprod, KS, KE, cand,
                                      gap_drop, sig, wi=wi, L=L,
                                      keep_cap=keep_cap)
    return counts, allowed, out


def _score_pairs(raw, cband, IR, Bprod, outs, pairs, cand, L, sig, gap_drop,
                 bh_backend, max_count, mesh=None, exact_ctx=None,
                 margin=0.0, check=False):
    """THE non-fused hiccups scoring ladder, one entry point (round-3
    verdict hygiene item: hiccups_chrom carried four near-duplicate
    scoring paths).  Tiers, per (p, w) pair:

    1. every pair's two backgrounds in ONE device program at the fast
       keep cap (:func:`_score_all_pairs`);
    2. hard-cap per-pair retry for entries that overflowed tier 1
       (:func:`_score_pair`);
    3. the per-background scorer (:func:`_score_one`) for everything the
       compact device scorers cannot serve — checkify instrumentation,
       host BH, keep-cap overflow — ending in the dense host-BH fallback.

    Returns a list of (rK, rY) host dicts aligned with ``pairs``."""
    multi = None
    if not check:
        multi = _score_all_pairs(raw, cband, IR, Bprod, outs, pairs, cand,
                                 L, sig, gap_drop, bh_backend, max_count,
                                 mesh=mesh, exact_ctx=exact_ctx,
                                 margin=margin)
    results = []
    for i, (pi, wi) in enumerate(pairs):
        pair = multi[i] if multi is not None else None
        if pair is None and not check:
            KS, KE, YS, YE = outs[pi]
            # after a tier-1 overflow the fast tier would deterministically
            # overflow again, so the retry starts at the hard cap
            caps = ((_KEEP_CAP,) if multi is not None
                    else (_KEEP_CAP_FAST, _KEEP_CAP))
            pair = _score_pair(raw, cband, IR, Bprod, KS, KE, YS, YE, wi,
                               cand, L, sig, gap_drop,
                               bh_backend=bh_backend, max_count=max_count,
                               caps=caps, mesh=mesh, exact_ctx=exact_ctx,
                               pi=pi, margin=margin)
        if pair is None:
            KS, KE, YS, YE = outs[pi]
            pair = tuple(
                _score_one(raw, cband, IR, Bprod, bS, bE, wi, cand, L, sig,
                           gap_drop, chunked=True, bh_backend=bh_backend,
                           max_count=max_count, check=check, mesh=mesh,
                           exact=exact_ctx and (exact_ctx, pi, kind),
                           margin=margin)
                for bS, bE, kind in ((KS, KE, 'K'), (YS, YE, 'Y')))
        results.append(pair)
    return results


def _score_all_pairs(raw, cband, IR, Bprod, outs, pairs, cand, L, sig,
                     gap_drop, bh_backend, max_count, mesh=None,
                     exact_ctx=None, margin=0.0):
    """Fused scoring of every (p, w) pair in one device program + one host
    fetch.  Returns a list of (rK, rY) aligned with ``pairs`` (entries are
    None on keep-cap overflow), or None when the fused path does not
    apply (host BH) — callers fall back per pair."""
    backend, o_cap = _bh_plan(True, bh_backend, max_count)
    if backend != 'device' or o_cap is None:
        return None
    caps = tuple(tuple(outs[pi]) for pi, _ in pairs)
    exact_mode = exact_ctx is not None
    outK, outY = _score_device_compact_multi(
        raw, cband, IR, Bprod, caps, cand, gap_drop, sig,
        wis=tuple(int(wi) for _, wi in pairs), L=int(L), chunked=True,
        o_cap=o_cap, keep_cap=_KEEP_CAP_FAST,
        mesh=mesh, exact_mode=exact_mode, margin=margin,
        s_rows=score_ops.chunk_rows(o_cap, float(sig)))
    # one bundled transfer of the stacked [n_pairs, ...] leaves
    fK_all, sK, fY_all, sY = _fetch((outK[:8], outK[9], outY[:8], outY[9]))
    results = []
    for i, (pi, _) in enumerate(pairs):
        rK = _compact_to_host(tuple(l[i] for l in fK_all), (outK[8], i),
                              _KEEP_CAP_FAST, sig=sig,
                              exact=exact_ctx and (exact_ctx, pi, 'K'),
                              sus=tuple(l[i] for l in sK) if sK else None)
        rY = _compact_to_host(tuple(l[i] for l in fY_all), (outY[8], i),
                              _KEEP_CAP_FAST, sig=sig,
                              exact=exact_ctx and (exact_ctx, pi, 'Y'),
                              sus=tuple(l[i] for l in sY) if sY else None)
        # an overflowing entry falls back to the per-pair scorer, which
        # retries at the hard cap
        results.append(None if rK is None or rY is None else (rK, rY))
    return results


@jax.jit
def _gather_pairs(a, d_idx, x_idx):
    """Tiny device gather for postcheck lookups into a resident dense
    array (index arrays are padded to bucketed sizes by the caller)."""
    return a[d_idx, x_idx]


@jax.jit
def _gather_pairs3(a, i, d_idx, x_idx):
    """Postcheck gather into a [n_pairs, num, Lp] stacked resident array.
    The multi-pair scorers keep ``prod`` stacked and defer the pair slice
    to here: most chromosomes have an empty postcheck, and an eager
    ``prod[i]`` would cost one device dispatch per (pair, background)."""
    return a[i, d_idx, x_idx]


def _gather_prod(prod, d_idx, x_idx):
    """Dispatch the right postcheck gather for a plain or (stacked, pair)
    ``prod`` handle."""
    if isinstance(prod, tuple):
        stacked, i = prod
        return _gather_pairs3(stacked, jnp.int32(i), d_idx, x_idx)
    return _gather_pairs(prod, d_idx, x_idx)


def _fetch(tree):
    """``jax.device_get`` that also works on a multi-process mesh.

    Global arrays whose shards live on other processes cannot be read
    directly; such leaves are first replicated with a jitted identity
    carrying replicated out_shardings (one all-gather — every leaf here
    is a <= keep_cap compacted bundle, a few MB at most).  Fully
    addressable or fully replicated leaves pass straight through."""
    def needs(l):
        return (isinstance(l, jax.Array) and not l.is_fully_addressable
                and not l.sharding.is_fully_replicated)

    leaves = [l for l in jax.tree_util.tree_leaves(tree) if needs(l)]
    if leaves:
        from jax.sharding import NamedSharding, PartitionSpec
        rep = NamedSharding(leaves[0].sharding.mesh, PartitionSpec())
        ident = _replicating_identity(rep)

        def reshard(l):
            return ident(l) if needs(l) else l

        tree = jax.tree_util.tree_map(reshard, tree)
    if jax.process_count() == 1:
        return _fetch_packed(tree)
    return jax.device_get(tree)


@functools.lru_cache(maxsize=32)
def _packer(sig):
    """One jitted pack program per leaf signature: every leaf bitcast to
    bytes and concatenated into ONE uint8 buffer, so the host round trip
    is a single transfer instead of one per leaf."""
    def pack(leaves):
        parts = []
        for l in leaves:
            flat = l.reshape(-1)
            if flat.dtype == jnp.bool_:
                flat = flat.astype(jnp.uint8)
            if flat.dtype.itemsize > 1:
                flat = jax.lax.bitcast_convert_type(flat, jnp.uint8)
            parts.append(flat.reshape(-1))
        return jnp.concatenate(parts) if parts else jnp.zeros(0, jnp.uint8)
    return jax.jit(pack)


def _fetch_packed(tree):
    """Single-transfer jax.device_get: pack every leaf into one uint8
    device buffer (jitted, cached per shape/dtype signature), fetch once,
    and rebuild the host tree with numpy views.  Bit-preserving for every
    dtype (bools travel as 0/1 bytes)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    arrs = [jnp.asarray(l) for l in leaves]
    sig = tuple((a.shape, str(a.dtype)) for a in arrs)
    buf = np.asarray(_packer(sig)(arrs))
    out = []
    off = 0
    for a in arrs:
        nbytes = a.size * (1 if a.dtype == jnp.bool_ else a.dtype.itemsize)
        raw = buf[off:off + nbytes]
        off += nbytes
        if a.dtype == jnp.bool_:
            out.append(raw.astype(np.bool_).reshape(a.shape))
        else:
            out.append(np.frombuffer(raw.tobytes(),
                                     dtype=np.dtype(str(a.dtype)))
                       .reshape(a.shape))
    return jax.tree_util.tree_unflatten(treedef, out)


@functools.lru_cache(maxsize=8)
def _replicating_identity(sharding):
    # one compiled all-gather identity per sharding (a fresh jit per call
    # would re-trace and re-compile on every fetch)
    return jax.jit(lambda x: x, out_shardings=sharding)


def _bh_plan(chunked, bh_backend, max_count):
    """Resolve 'auto' and the histogram-BH count cap (shared by the
    single- and pair-background scorers).  'auto' is the device: the
    sort-free histogram BH (chunked, counts <= 2^17), the sort-free
    fixpoint global BH (bhfdr), or the device sort (deeper maps)."""
    if bh_backend == 'auto':
        bh_backend = 'device'
    o_cap = None
    if chunked and bh_backend == 'device' and max_count is not None and \
            max_count <= (1 << 17):
        # power-of-two cap so chromosomes share compiled programs; the
        # floor is 1024 because typical per-chromosome max counts straddle
        # 256-1000 and o_cap is a static argument of the fused program —
        # a genome whose chromosomes landed on 256/512/1024 would compile
        # three times for a few ms of histogram width
        o_cap = 1024
        while o_cap < int(max_count):
            o_cap *= 2
    return bh_backend, o_cap


def _compact_to_host(fetched, prod, cap=_KEEP_CAP, sig=None, exact=None,
                     sus=None):
    """(cnt, idx..., stats...) device bundle -> host dict, or None on
    keep-cap overflow.

    With ``sig`` the bundle is the histogram form — (..., cid, hist)
    instead of (..., p, q) — from a chunked superset keep: exact float64
    p/q are completed from the integer histogram and the superset is
    filtered with the true ``sig`` (ops/score.host_chunk_complete).

    ``exact`` = (ExactCtx, p, kind) additionally recomputes E itself in
    float64 on the host (ops/hostexact.py): chunk ids, Fold and ICE then
    carry the reference's own float64 values instead of the device's
    f32 pipeline.  ``sus`` (the fetched suspect bundle from
    engine._compact_one's exact mode) closes the last f32 leak: the
    integer histogram is corrected for lambda-chunk edge suspects whose
    float64 chunk differs from the f32 one, the suspects' keep/stats are
    decided host-side from the corrected float64 table, and the device's
    count thresholds are audited against that table (any potentially
    missed non-suspect pixel -> None, the caller falls back)."""
    cnt, d_idx, x_idx, Ov, ICEv, Foldv, a7, a8 = fetched
    n = int(cnt)
    if n > cap:
        return None
    d_idx, x_idx = d_idx[:n], x_idx[:n]
    if sig is None:
        return dict(x=x_idx, y=x_idx + d_idx, O=Ov[:n], ICE=ICEv[:n],
                    Fold=Foldv[:n], p=a7[:n], q=a8[:n], prod=prod)
    if exact is not None:
        from ..ops import hostexact
        ctx, p_set, kind = exact
        hist64 = np.asarray(a8, np.int64)
        S, C = hist64.shape
        sus_data = None
        if sus:
            ns = int(sus[0])
            if ns > sus[1].shape[0]:
                return None          # suspect-cap overflow: caller retries
            ds, xs = sus[1][:ns], sus[2][:ns]
            # the device folded chunks >= S into overflow row S-1
            # (ops/score.chunk_rows; _chunk_pack's clip), so the
            # subtraction must target the row the pixel actually occupies
            cid_dev = np.clip(np.asarray(sus[3][:ns], np.int64), 0, S - 1)
            O_s = np.asarray(sus[4][:ns], np.int64)
            gap_s = np.asarray(sus[5][:ns], bool)
            thr_dev = np.asarray(sus[6], np.int64)
            O64s, E64s, fold64s, ice64s = hostexact.exact_stats(
                ctx, ds, xs, p_set, kind)
            cid64s, valid64s = hostexact.chunk_ids64(E64s, E64s > 0)
            cid_new = np.where(valid64s, np.clip(cid64s, 0, S - 1), 0)
            # move each suspect from its device (chunk, count) cell to its
            # float64 one (row 0 = the invalid trash row, both ways)
            np.add.at(hist64, (cid_dev, O_s), -1)
            np.add.at(hist64, (cid_new, O_s), 1)
            sus_data = (ds, xs, cid_new, O_s, gap_s, O64s, fold64s,
                        ice64s, valid64s, thr_dev)
        O64, E64, fold64, ice64 = hostexact.exact_stats(
            ctx, d_idx, x_idx, p_set, kind)
        cid64, valid64 = hostexact.chunk_ids64(E64, E64 > 0)
        ptab, qtab = score_ops.host_chunk_qtab64(hist64)
        oc = np.clip(np.floor(O64).astype(np.int64), 0, C - 1)
        cs = np.clip(cid64, 0, S - 1)
        p64 = np.where(valid64, ptab[cs, oc], 1.0)
        q64 = np.where(valid64, qtab[cs, oc], 1.0)
        fin = q64 <= sig
        out = dict(x=x_idx[fin], y=x_idx[fin] + d_idx[fin], O=O64[fin],
                   ICE=ice64[fin], Fold=fold64[fin], p=p64[fin],
                   q=q64[fin], prod=prod)
        if sus_data is not None:
            (ds, xs, cid_new, O_s, gap_s, O64s, fold64s, ice64s, valid64s,
             thr_dev) = sus_data
            # audit the device superset against the CORRECTED table: a
            # non-suspect pixel was emitted only if its count cleared the
            # device threshold of its (f64 == f32 by the margin bound)
            # chunk; a corrected-table cell significant below that
            # threshold that still holds non-suspect pixels could hide a
            # missed peak (row 0 is the invalid trash row)
            hist_nosus = hist64.copy()
            np.add.at(hist_nosus, (cid_new, O_s), -1)
            counts_i = np.arange(C, dtype=np.int64)[None, :]
            missed = ((qtab <= sig) & (counts_i < thr_dev[:, None])
                      & (hist_nosus > 0))
            missed[0, :] = False
            if missed.any():
                import logging
                logging.getLogger(__name__).warning(
                    'suspect-corrected BH table made %d (chunk, count) '
                    'cells significant below the device keep threshold — '
                    'falling back to the dense scorer for this background '
                    '(f32-chunked; loci unaffected)', int(missed.sum()))
                return None
            p64s = np.where(valid64s, ptab[cid_new, O_s], 1.0)
            q64s = np.where(valid64s, qtab[cid_new, O_s], 1.0)
            fin_s = (q64s <= sig) & ~gap_s
            out = dict(
                x=np.concatenate([out['x'], xs[fin_s]]),
                y=np.concatenate([out['y'], xs[fin_s] + ds[fin_s]]),
                O=np.concatenate([out['O'], O64s[fin_s]]),
                ICE=np.concatenate([out['ICE'], ice64s[fin_s]]),
                Fold=np.concatenate([out['Fold'], fold64s[fin_s]]),
                p=np.concatenate([out['p'], p64s[fin_s]]),
                q=np.concatenate([out['q'], q64s[fin_s]]),
                prod=prod)
        return out
    p64, q64 = score_ops.host_chunk_complete(Ov[:n], a7[:n], a8)
    fin = q64 <= sig
    return dict(x=x_idx[fin], y=x_idx[fin] + d_idx[fin], O=Ov[:n][fin],
                ICE=ICEv[:n][fin], Fold=Foldv[:n][fin], p=p64[fin],
                q=q64[fin], prod=prod)


def _score_pair(raw, cband, IR, Bprod, KS, KE, YS, YE, wi, cand, L, sig,
                gap_drop, bh_backend='auto', max_count=None,
                caps=(_KEEP_CAP_FAST, _KEEP_CAP), mesh=None, exact_ctx=None,
                pi=None, margin=0.0):
    """Fused scoring of both hiccups backgrounds in one device program +
    one host fetch.  Returns (rK, rY), or None when the fused device
    path does not apply (host BH, or keep-cap overflow) — the caller
    then falls back to two :func:`_score_one` calls.  ``caps`` lets a
    caller that already overflowed the fast tier start at the hard cap."""
    backend, o_cap = _bh_plan(True, bh_backend, max_count)
    if backend != 'device' or o_cap is None:
        return None
    exact_mode = exact_ctx is not None
    for cap in caps:
        outK, outY = _score_device_compact_pair(
            raw, cband, IR, Bprod, KS, KE, YS, YE, cand, gap_drop, sig,
            wi=int(wi), L=int(L), chunked=True, o_cap=o_cap, keep_cap=cap,
            mesh=mesh, exact_mode=exact_mode,
            sus_cap=max(_SUS_CAP, cap), margin=margin,
            s_rows=score_ops.chunk_rows(o_cap, float(sig)))
        # one bundled transfer
        fK, sK, fY, sY = _fetch((outK[:8], outK[9], outY[:8], outY[9]))
        rK = _compact_to_host(fK, outK[8], cap, sig=sig,
                              exact=exact_ctx and (exact_ctx, pi, 'K'),
                              sus=sK or None)
        rY = _compact_to_host(fY, outY[8], cap, sig=sig,
                              exact=exact_ctx and (exact_ctx, pi, 'Y'),
                              sus=sY or None)
        if rK is not None and rY is not None:
            return rK, rY
    return None


@functools.partial(jax.jit, static_argnames=('wi', 'keep_cap'))
def _score_device_bhfdr_compact(raw, cband, IR, Bprod, bSV, bEV, cand,
                                gap_drop, sig, wi, L, keep_cap):
    """Global-BH (bhfdr, callers.py:545) scoring with NO device sort and
    NO dense host fetch: the sort-free fixpoint keep superset
    (ops/score.global_bh_keep) and compaction; the controller finishes
    exact float64 BH on the <= keep_cap compacted pixels
    (ops/score.host_bh_complete).

    The device emits no per-pixel ranks: every pixel with
    ``p64 <= tau`` (the exact BH threshold) is inside the superset by
    construction, so the float64 rank of any potentially-kept pixel —
    ``#{j : p64_j <= p64_i}`` — is computable on the host from the
    superset's own float64 p-values alone (a round-2 device pass counted
    f32-ordered ranks over the full sheet, which both cost a
    [keep_cap x pixels] compare-reduce and drifted from the reference's
    float64 ordering at f32 ties)."""
    E, O, ICE, Fold, scored, prod = score_ops.expected_observed(
        raw, cband, IR, Bprod, bSV, bEV, wi, cand, L)
    pval = jnp.where(scored, score_ops.poisson_sf(O, E), 1.0)
    keep_sup, m = score_ops.global_bh_keep(pval, scored, sig)
    # the gap filter is post-BH in the reference (callers.py:556-577):
    # gap pixels participate in the ranks AND in the suffix-min that
    # determines other pixels' q, so they must stay in the compacted
    # superset; the controller drops them from the emitted set only.
    # g(E) rides along so the controller recomputes the compacted pixels'
    # p in float64 (scipy sf) instead of emitting the f32 gammainc value.
    cnt, d_idx, x_idx = score_ops.compact_mask(keep_sup, keep_cap)
    g = lambda a: a[d_idx, x_idx]
    p_small = g(pval)
    return (cnt, d_idx, x_idx, g(O), g(ICE), g(Fold), p_small, g(E),
            m, g(gap_drop), prod)


@functools.partial(jax.jit, static_argnames=('wi', 'L', 'keep_cap'))
def _score_device_bhfdr_compact_checked(raw, cband, IR, Bprod, bSV, bEV,
                                        cand, gap_drop, sig, wi, L,
                                        keep_cap):
    """checkify-instrumented twin of :func:`_score_device_bhfdr_compact`
    (same float/index checks as the chunked twin)."""
    from jax.experimental import checkify

    def body(raw, cband, IR, Bprod, bSV, bEV, cand, gap_drop, sig):
        return _score_device_bhfdr_compact.__wrapped__(
            raw, cband, IR, Bprod, bSV, bEV, cand, gap_drop, sig,
            wi, L, keep_cap)

    return checkify.checkify(
        body, errors=checkify.float_checks | checkify.index_checks)(
            raw, cband, IR, Bprod, bSV, bEV, cand, gap_drop, sig)


def _bhfdr_to_host(fetched, prod, cap, sig, exact=None):
    """bhfdr compact bundle -> host dict with exact float64 p/q completion
    (shared by the fused single-program path and :func:`_score_one`), or
    None on keep-cap overflow."""
    cnt, d_idx, x_idx, Ov, ICEv, Foldv, pv, Ev, m, gapv = fetched
    n = int(cnt)
    if n > cap:
        return None
    d_idx, x_idx = d_idx[:n], x_idx[:n]
    # float64 p from the compacted (O, E), evaluated as 1 - cdf — the
    # reference's own expression (callers.py:541), tail-saturation
    # artifacts included; the device's f32 gammainc served only the
    # superset search.
    from scipy.stats import poisson as _poisson
    Ovn, ICEn, Foldn = Ov[:n], ICEv[:n], Foldv[:n]
    E64 = np.asarray(Ev[:n], np.float64)
    if exact is not None:
        # float64 E from exact ring-sum replay: the last f32 leak in the
        # emitted stats (ops/hostexact.py)
        from ..ops import hostexact
        ctx, p_set, kind = exact
        Ovn, E64, Foldn, ICEn = hostexact.exact_stats(
            ctx, d_idx, x_idx, p_set, kind)
    p64 = 1.0 - _poisson.cdf(
        np.floor(np.asarray(Ovn, np.float64)), E64)
    # exact float64 global ranks from the superset alone: #{j: p64_j <=
    # p64_i} counts only superset members for every pixel with p64 <= tau
    # (any such j has p64_j <= p64_i <= tau, hence is itself in the
    # superset — see global_bh_keep); superset pixels above tau may read
    # an undercount, but their raw BH terms then only grow, and no term
    # above tau can determine a kept pixel's q
    p_sorted = np.sort(p64, kind='stable')
    ranks64 = np.searchsorted(p_sorted, p64, side='right')
    q = score_ops.host_bh_complete(p64, ranks64, m, sig)
    # exact f64 filter of the superset + the post-BH gap drop
    fin = (q <= sig) & ~gapv[:n]
    return dict(x=x_idx[fin], y=x_idx[fin] + d_idx[fin],
                O=Ovn[fin], ICE=ICEn[fin], Fold=Foldn[fin], p=p64[fin],
                q=q[fin], prod=prod)


def _score_one(raw, cband, IR, Bprod, bSV, bEV, wi, cand, L, sig, gap_drop,
               chunked: bool, bh_backend='auto', max_count=None,
               check=False, mesh=None, exact=None, margin=0.0):
    """Poisson scoring of one background; returns host-side kept-pixel
    arrays (x, y, O, ICE, Fold, p, q) plus the dense EM*ratio product.
    ``check=True`` routes through the checkify-instrumented program and
    raises on any NaN/inf/OOB the instrumentation observes.  ``exact`` =
    (ExactCtx, p, kind) upgrades the compacted pixels' emitted statistics
    to the reference's float64 values (ops/hostexact.py)."""
    bh_backend, o_cap = _bh_plan(chunked, bh_backend, max_count)
    if check:
        bh_backend = 'device'   # the instrumented program is the device one
    if not chunked and bh_backend == 'device':
        for cap in (_KEEP_CAP_FAST, _KEEP_CAP):
            if check:
                err, out = _score_device_bhfdr_compact_checked(
                    raw, cband, IR, Bprod, bSV, bEV, cand, gap_drop, sig,
                    wi=int(wi), L=int(L), keep_cap=cap)
                err.throw()
            else:
                out = _score_device_bhfdr_compact(
                    raw, cband, IR, Bprod, bSV, bEV, cand, gap_drop, sig,
                    wi=int(wi), L=int(L), keep_cap=cap)
            r = _bhfdr_to_host(_fetch(out[:10]), out[10], cap, sig,
                               exact=exact)
            if r is not None:
                return r
        # cap overflow (pathological siglevel/data): dense fallback below
        bh_backend = 'host'
    if bh_backend == 'device':
        for cap in (_KEEP_CAP_FAST, _KEEP_CAP):
            if check:
                err, out = _score_device_compact_checked(
                    raw, cband, IR, Bprod, bSV, bEV, cand, gap_drop, sig,
                    wi=int(wi), L=int(L), chunked=chunked, o_cap=o_cap,
                    keep_cap=cap)
                err.throw()
            else:
                out = _score_device_compact(
                    raw, cband, IR, Bprod, bSV, bEV, cand, gap_drop, sig,
                    wi=int(wi), L=int(L), chunked=chunked, o_cap=o_cap,
                    keep_cap=cap, mesh=mesh,
                    exact_mode=exact is not None and not check,
                    sus_cap=max(_SUS_CAP, cap), margin=margin,
                    s_rows=score_ops.chunk_rows(o_cap, float(sig)))
            # one bundled host transfer
            fetched, sus_f = _fetch((out[:8], out[9]))
            n = int(fetched[0])
            if n <= cap:
                r = _compact_to_host(
                    fetched, out[8], cap,
                    sig=sig if (chunked and o_cap is not None) else None,
                    exact=exact if (chunked and o_cap is not None) else None,
                    sus=sus_f or None)
                if r is not None:
                    return r
        # cap overflow (pathological siglevel/data): dense fallback below

    (pval, cid, valid, qval, keep, scored, O, ICE, Fold, prod,
     Edense) = _score_device(
        raw, cband, IR, Bprod, bSV, bEV, cand, gap_drop, sig,
        wi=int(wi), L=int(L), chunked=chunked,
        with_bh=not chunked and bh_backend == 'device', o_cap=o_cap)
    if chunked:
        # exact float64 completion from the dense fetch: p/q depend only on
        # (chunk, count), so the controller rebuilds the per-chunk BH from
        # an integer histogram (ops/score.host_chunk_dense)
        pval_np, qval_np, keepq = score_ops.host_chunk_dense(
            np.asarray(O), np.asarray(cid), np.asarray(valid), sig)
        keep_np = keepq & ~np.asarray(gap_drop)
    elif bh_backend == 'device':
        keep_np = np.asarray(keep)
        qval_np = np.asarray(qval)
        pval_np = np.asarray(pval)
    else:
        # float64 p over the valid pixels (1 - cdf, the reference's own
        # expression, callers.py:541 — this is the rare fallback path),
        # then exact f64 global BH
        from scipy.stats import poisson as _poisson
        v = np.asarray(valid)
        pval_np = np.ones(v.shape, np.float64)
        pval_np[v] = 1.0 - _poisson.cdf(
            np.floor(np.asarray(O, np.float64)[v]),
            np.asarray(Edense, np.float64)[v])
        qval_np = score_ops.host_bh(pval_np, cid, valid)
        reject = np.asarray(scored) & (qval_np <= sig)
        keep_np = reject & ~np.asarray(gap_drop)

    d_idx, x_idx = np.nonzero(keep_np)
    y_idx = x_idx + d_idx
    take = lambda a: np.asarray(a)[d_idx, x_idx]
    return dict(x=x_idx, y=y_idx, O=take(O), ICE=take(ICE), Fold=take(Fold),
                p=pval_np[d_idx, x_idx], q=qval_np[d_idx, x_idx], prod=prod)


def _exact_capable(bands):
    """Whether the bands can serve float64 host completion (legacy bands
    lack the float64 vector copies).  Sharded multi-host bands qualify
    through their per-host column spans (``raw_spans``): the window-cell
    gather is reduced exactly across processes, so the emitted statistics
    stay bit-identical at any process count."""
    if getattr(bands, 'w064', None) is None:
        return False
    return bool(isinstance(getattr(bands, 'raw', None), np.ndarray)
                or getattr(bands, 'raw_spans', None) is not None)


def _exact_ctx(bands, plan, allowed, thr):
    """ExactCtx for float64 host completion of the compacted pixels'
    emitted statistics, or None when the bands cannot serve it."""
    if not _exact_capable(bands):
        return None
    from ..ops.hostexact import ExactCtx
    return ExactCtx(bands, plan, allowed, thr)


def _count_pass(raw, cand, plan, p_list, thr, mesh):
    """Dispatch the freeze-count pass (pass A): halo-exchanged sharded
    scan on a mesh, the plain scan otherwise."""
    if mesh is not None:
        from ..parallel import tiles
        return tiles.scan_pass_a_sharded(raw, cand, plan, p_list, thr, mesh)
    return scan_ops.scan_pass_a(raw, cand, plan, p_list, thr)


def _capture_pass(raw, cband, eband, cand, allowed, plan, p_list, thr,
                  mesh):
    """Dispatch the capture pass (pass B): halo-exchanged sharded scan on
    a mesh, the plain scan otherwise."""
    if mesh is not None:
        from ..parallel import tiles
        _, _, outs = tiles.scan_pass_b_sharded(
            raw, cband, eband, cand, allowed, plan, p_list, thr, mesh)
        return outs
    _, _, outs = scan_ops.scan_pass_b(raw, cband, eband, cand, allowed,
                                      plan, p_list, thr)
    return outs


def _bhfdr_fused(bands: ChromBands, cfg: BHFDRConfig, plan, total):
    """One-dispatch bhfdr chromosome (fused program + single compacted
    fetch), or None on hard-cap overflow (the caller falls back to the
    multi-dispatch path, which ends in the dense host-BH fallback)."""
    res = bands.res
    raw_op, bits, w0, bias, IR, gap = _staged_operands(bands)
    args = (raw_op, w0, bias, IR, gap, jnp.float32(cfg.siglevel),
            np.int32(total), np.int32(poolplan.left_threshold(total)))
    for cap in (_KEEP_CAP_FAST, _KEEP_CAP):
        counts, allowed_d, out = _fused_bhfdr_device(
            *args, plan=plan, p_list=(cfg.pw,), thr=16, wi=int(cfg.ww),
            ww_min=bands.ww_min, L=int(bands.L), d_lo=cfg.ww,
            d_hi=np.int32(cfg.maxapart // res), gap_s=cfg.ww,
            keep_cap=cap, bits=bits)
        counts_h, allowed_h, f10 = _fetch((counts, allowed_d, out[:10]))
        decision = poolplan.emulate_freeze_bhfdr(plan, counts_h, total)
        assert np.array_equal(np.asarray(allowed_h),
                              np.asarray(decision.allowed)), \
            'device freeze emulation diverged from the host replay'
        ctx = _exact_ctx(bands, plan, decision.allowed, 16)
        r = _bhfdr_to_host(f10, out[10], cap, cfg.siglevel,
                           exact=ctx and (ctx, cfg.pw, 'K'))
        if r is not None:
            return r
    return None


def bhfdr_chrom(bands: ChromBands, cfg: BHFDRConfig, mesh=None,
                bh_backend='auto', check=False, ir_backend='host'):
    """Donut-only caller (reference callers.py:364-590).  Returns
    {(x_bp, y_bp): (cen_x_bp, cen_y_bp, radius_bp, O, Fold, p, q)}.
    With ``mesh`` the scan shards band tiles across devices with halo
    exchange and psum-reduced freeze counts; ``ir_backend='device'``
    additionally derives the distance-expected IR with a psum over the
    sharded slab instead of reading the controller's."""
    res = bands.res
    L, num = bands.L, bands.num
    plan = tuple(poolplan.bhfdr_pool_plan(cfg.pw, cfg.ww, cfg.maxww))
    total = bands.candidate_total(cfg.ww, cfg.maxapart // res)

    r = None
    if (mesh is None and not check and _fused_enabled()
            and _bh_plan(False, bh_backend, None)[0] == 'device'
            and 10 * total < (1 << 31)):
        # production fast path: the whole chromosome in ONE device
        # dispatch (sheets + pass A + freeze emulation + pass B + compact
        # global-BH scorer) and one compacted fetch
        r = _bhfdr_fused(bands, cfg, plan, total)
    if r is None:
        raw, cband, eband, IR, Bprod, gap_drop, cand = _prep_chrom(
            bands, cfg.ww, cfg.maxapart // res, cfg.ww, mesh,
            ir_backend=ir_backend)
        counts = _count_pass(raw, cand, plan, (cfg.pw,), 16, mesh)
        decision = poolplan.emulate_freeze_bhfdr(plan, np.asarray(counts),
                                                 total)
        allowed = jnp.asarray(decision.allowed)
        outs = _capture_pass(raw, cband, eband, cand, allowed, plan,
                             (cfg.pw,), 16, mesh)
        KS, KE, _, _ = outs[cfg.pw]

        ctx = _exact_ctx(bands, plan, decision.allowed, 16)
        r = _score_one(raw, cband, IR, Bprod, KS, KE, cfg.ww, cand, L,
                       cfg.siglevel, gap_drop, chunked=False,
                       bh_backend=bh_backend, check=check,
                       exact=ctx and (ctx, cfg.pw, 'K'))

    Donuts = {(int(x), int(y)): (float(o), float(f), float(p), float(q))
              for x, y, o, f, p, q in zip(r['x'], r['y'], r['O'], r['Fold'],
                                          r['p'], r['q'])}
    pixel_list = local_clustering(Donuts, None, res,
                                  min_count=cfg.min_marginal_peaks,
                                  r=2 * res, onlysummit=cfg.only_anchors)
    pixel_table = {}
    for pixel, cen, radius in pixel_list:
        donut = Donuts[pixel]
        if donut[1] > 2:   # post-clustering fold gate, callers.py:587
            pixel_table[(pixel[0] * res, pixel[1] * res)] = \
                (cen[0] * res, cen[1] * res, radius * res) + donut
    return pixel_table


def fused_hiccups_launch(bands: ChromBands, cfg: HiccupsConfig, plan,
                         total, o_cap, lower=False):
    """Enqueue the production one-program hiccups chromosome and return
    its device outputs (counts, allowed, outK, outY) without fetching —
    the unit bench.py and chip_smoke.py time.  ``lower=True`` returns the
    lowered program instead (for compile timing and memory analysis)."""
    raw_op, bits, w0, bias, IR, gap = _staged_operands(bands)
    program = _fused_hiccups_device.lower if lower else _fused_hiccups_device
    return program(
        raw_op, w0, bias, IR, gap, jnp.float32(cfg.siglevel),
        np.int32(total), np.int32(poolplan.left_threshold(total)),
        plan=plan, p_list=tuple(sorted(set(cfg.pw))),
        thr=cfg.min_local_reads, ww_t=tuple(cfg.ww),
        wis=tuple((int(p), int(w)) for p, w in zip(cfg.pw, cfg.ww)),
        ww_min=bands.ww_min, L=int(bands.L), d_lo=min(cfg.ww),
        d_hi=np.int32(cfg.maxapart // bands.res), gap_s=min(cfg.ww),
        o_cap=o_cap, keep_cap=_KEEP_CAP_FAST, bits=bits,
        exact_mode=_exact_capable(bands), margin=_chunk_margin(plan),
        s_rows=score_ops.chunk_rows(o_cap, cfg.siglevel))


def _hiccups_fused(bands: ChromBands, cfg: HiccupsConfig, plan, pairs,
                   total, o_cap):
    """One-dispatch hiccups chromosome: the fused program + one compacted
    fetch, completed to per-pair (rK, rY) host dicts.  Returns None when
    any pair overflows the fast keep cap (the caller falls back to the
    multi-dispatch path, which retries at the hard cap)."""
    counts, allowed_d, outK, outY = fused_hiccups_launch(bands, cfg, plan,
                                                         total, o_cap)
    counts_h, allowed_h, fK_all, sK, fY_all, sY = _fetch(
        (counts, allowed_d, outK[:8], outK[9], outY[:8], outY[9]))
    decision = poolplan.emulate_freeze_hiccups(plan, counts_h, total,
                                               cfg.ww)
    assert np.array_equal(np.asarray(allowed_h),
                          np.asarray(decision.allowed)), \
        'device freeze emulation diverged from the host replay'
    ctx = _exact_ctx(bands, plan, decision.allowed, cfg.min_local_reads)
    results = []
    for i, (pi, _) in enumerate(pairs):
        rK = _compact_to_host(tuple(l[i] for l in fK_all), (outK[8], i),
                              _KEEP_CAP_FAST, sig=cfg.siglevel,
                              exact=ctx and (ctx, pi, 'K'),
                              sus=tuple(l[i] for l in sK) if sK else None)
        rY = _compact_to_host(tuple(l[i] for l in fY_all), (outY[8], i),
                              _KEEP_CAP_FAST, sig=cfg.siglevel,
                              exact=ctx and (ctx, pi, 'Y'),
                              sus=tuple(l[i] for l in sY) if sY else None)
        if rK is None or rY is None:
            return None
        results.append((rK, rY))
    return results


def hiccups_chrom(bands: ChromBands, cfg: HiccupsConfig, mesh=None,
                  bh_backend='auto', check=False, ir_backend='host'):
    """Two-background multi-parameter caller (reference callers.py:44-362).
    Returns {(x_bp, y_bp): (cen_x, cen_y, radius, O, FoldK, pK, qK,
    FoldY, pY, qY)} in bp.  With ``mesh`` the scan shards band tiles
    across devices (halo exchange + psum'd freeze counts);
    ``ir_backend='device'`` derives IR with a psum over the sharded slab."""
    res = bands.res
    L, num = bands.L, bands.num
    pw, ww = tuple(cfg.pw), tuple(cfg.ww)
    plan = tuple(poolplan.hiccups_pool_plan(pw, ww, cfg.maxww))
    p_list = tuple(sorted(set(pw)))
    total = bands.candidate_total(min(ww), cfg.maxapart // res)
    pairs = list(zip(pw, ww))

    fused_results = None
    if (mesh is None and not check and _fused_enabled()
            and 10 * total < (1 << 31)):
        max_count = getattr(bands, 'max_count', None)
        if max_count is None:
            max_count = float(bands.raw.max())
        bh_resolved, o_cap = _bh_plan(True, bh_backend, max_count)
        if bh_resolved == 'device' and o_cap is not None:
            # production fast path: the whole chromosome in ONE device
            # dispatch (sheets + pass A + freeze emulation + pass B +
            # fused multi-pair compact scorer) and one compacted fetch
            fused_results = _hiccups_fused(bands, cfg, plan, pairs, total,
                                           o_cap)

    if fused_results is None:
        raw, cband, eband, IR, Bprod, gap_drop, cand = _prep_chrom(
            bands, min(ww), cfg.maxapart // res, min(ww), mesh,
            ir_backend=ir_backend)

        counts = _count_pass(raw, cand, plan, p_list, cfg.min_local_reads,
                             mesh)
        decision = poolplan.emulate_freeze_hiccups(plan, np.asarray(counts),
                                                   total, ww)
        allowed = jnp.asarray(decision.allowed)
        outs = _capture_pass(raw, cband, eband, cand, allowed, plan, p_list,
                             cfg.min_local_reads, mesh)

        max_count = getattr(bands, 'max_count', None)
        if max_count is None:
            max_count = float(bands.raw.max())

        ctx = _exact_ctx(bands, plan, decision.allowed, cfg.min_local_reads)
        fused_results = _score_pairs(raw, cband, IR, Bprod, outs, pairs,
                                     cand, L, cfg.siglevel, gap_drop,
                                     bh_backend, max_count, mesh=mesh,
                                     exact_ctx=ctx,
                                     margin=_chunk_margin(plan),
                                     check=check)

    pixel_table = {}
    for pair_idx, (pi, wi) in enumerate(pairs):
        rK, rY = fused_results[pair_idx]

        first = rK['O'] if cfg.use_raw else rK['ICE']
        preDonuts = {(int(x), int(y)): (fi, o, f, p, q)
                     for x, y, fi, o, f, p, q in zip(
                         rK['x'], rK['y'], first, rK['O'], rK['Fold'],
                         rK['p'], rK['q'])}
        preLL = {(int(x), int(y)): (i, o, f, p, q)
                 for x, y, i, o, f, p, q in zip(
                     rY['x'], rY['y'], rY['ICE'], rY['O'], rY['Fold'],
                     rY['p'], rY['q'])}

        commonPos = set(preDonuts) & set(preLL)
        postcheck = set(preDonuts) - set(preLL)
        if postcheck:
            # cEM here is the Y background's expected matrix (the reference
            # reuses the loop variable, callers.py:329-331).  rY['prod'] is
            # resident on device; gather just the postcheck entries instead
            # of fetching the dense sheet (bucketed index padding keeps the
            # compile count low).
            pc = list(postcheck)
            cap = 128
            while cap < len(pc):
                cap *= 2
            di = np.zeros(cap, np.int32)
            xi = np.zeros(cap, np.int32)
            di[:len(pc)] = [cj - ci for ci, cj in pc]
            xi[:len(pc)] = [ci for ci, _ in pc]
            vals = np.asarray(_fetch(_gather_prod(
                rY['prod'], jnp.asarray(di), jnp.asarray(xi))))[:len(pc)]
            for (ci, cj), v in zip(pc, vals):
                if v == 0:
                    commonPos.add((ci, cj))

        for key in commonPos:
            donut = preDonuts[key]
            ll = preLL.get(key, donut)
            bpkey = (key[0] * res, key[1] * res)
            if (donut[2] > cfg.double_fold) and (ll[2] > cfg.double_fold) and \
                    ((donut[2] > cfg.single_fold) or (ll[2] > cfg.single_fold)):
                if bpkey not in pixel_table:
                    pixel_table[bpkey] = bpkey + (0,) + donut + ll[2:]
                elif (donut[-1] < pixel_table[bpkey][7]) and \
                        (ll[-1] < pixel_table[bpkey][10]):
                    pixel_table[bpkey] = bpkey + (0,) + donut + ll[2:]

    Donuts = {(k[0] // res, k[1] // res): pixel_table[k][3:8]
              for k in pixel_table}
    LL = {(k[0] // res, k[1] // res): pixel_table[k][8:] for k in pixel_table}
    peak_list = local_clustering(Donuts, LL, res,
                                 min_count=cfg.min_marginal_peaks,
                                 r=2 * res, sumq=cfg.sumq,
                                 onlysummit=cfg.only_anchors)
    final_table = {}
    for pixel, cen, radius in peak_list:
        key = (pixel[0] * res, pixel[1] * res)
        final_table[key] = (cen[0] * res, cen[1] * res, radius * res) + \
            pixel_table[key][4:]
    return final_table
