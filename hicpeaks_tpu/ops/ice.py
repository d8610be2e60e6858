"""On-device ICE matrix balancing (iterative correction).

JAX replacement for the reference's ``balance()`` wrapper around
``cooler.ice.iterative_correction`` (utilities.py:367-431).  The reference
balances cis-only (per SURVEY §2.5 the cooler metadata drives
``cis_only=True``), which in cooler means each chromosome is corrected
independently; marginal sweeps here are two fused passes over the dense
band tensor instead of chunked sparse matvecs over a process pool.

Knobs and semantics follow the reference call site: chunk-free, mad_max=5,
min_nnz=10, min_count=0, ignore_diags=1, tol=1e-5, max_iters=200, with
``rescale_marginals`` (bias /= sqrt(mean nonzero marginal)) and NaN at
filtered-out bins.  Convergence is tested on the scale-free variance of the
nonzero marginals (variance of marginals divided by their mean), which is
invariant to overall depth.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


def _sliding_rows(v, R, C):
    """W[d, x] = v[d + x] for a 1-D ``v`` (sliding windows) built from
    tile+pad+reshape only — XLA-friendly, no gather."""
    n = v.shape[0]
    flat = jnp.tile(v, R)
    flat = jnp.concatenate([flat, jnp.zeros(R, v.dtype)])
    W = flat[:R * (n + 1)].reshape(R, n + 1)
    return W[:, :C]


def _shear_right(A):
    """B[d, y] = A[d, y - d] (rows right-shifted by their index, zero fill)
    via the pad+reshape skew trick; output width = A's width."""
    R, C = A.shape
    A2 = jnp.concatenate([A, jnp.zeros((R, R), A.dtype)], axis=1)
    flat = A2.reshape(-1)
    W = flat[:R * (C + R - 1)].reshape(R, C + R - 1)
    return W[:, :C]


def _sym_marginal(band, b, L):
    """Marginal of the bias-scaled symmetric matrix from its upper band:
    m[x] = sum_j S[x, j] b[x] b[j] / b[x] ... concretely the row+column
    contributions of every stored pixel (diagonal counted once)."""
    num_p, Lp = band.shape
    bpad = jnp.concatenate([b, jnp.zeros(num_p, b.dtype)])
    By = _sliding_rows(bpad, num_p, Lp)                # By[d, x] = b[x + d]
    scaled = band * b[None, :] * By
    rowpart = jnp.sum(scaled, axis=0)                  # contribution to bin x
    # contribution to bin y = x + d  (exclude d=0: already in rowpart)
    src = scaled.at[0, :].set(0.0)
    colpart = jnp.sum(_shear_right(src), axis=0)
    return rowpart + colpart


@dataclass
class IceResult:
    bias: np.ndarray
    var: float
    converged: bool
    n_iters: int
    scale: float


@functools.partial(jax.jit, static_argnames=('L', 'ignore_diags', 'min_nnz',
                                             'min_count', 'mad_max',
                                             'max_iters'))
def _ice_device(band, L, ignore_diags, min_nnz, min_count, mad_max,
                tol, max_iters):
    num_p, Lp = band.shape
    d = jnp.arange(num_p)[:, None]
    x = jnp.arange(Lp)[None, :]
    band = jnp.where(d < ignore_diags, 0.0, band)
    band = jnp.where(x < (L - d), band, 0.0)

    ones = jnp.ones(Lp, band.dtype)
    col_in = jnp.arange(Lp) < L

    # --- bin filters (cooler's _init/_filters equivalents) ---
    nz = (band != 0).astype(band.dtype)
    nnz_row = jnp.sum(nz, axis=0)
    nnz_col = jnp.sum(_shear_right(nz.at[0, :].set(0.0)), axis=0)
    nnz = nnz_row + nnz_col
    marg0 = _sym_marginal(band, ones, L)

    mask = col_in
    if min_nnz > 0:
        mask = mask & (nnz >= min_nnz)
    if min_count > 0:
        mask = mask & (marg0 >= min_count)

    if mad_max > 0:
        m = jnp.where(mask, marg0, 0.0)
        pos = m > 0
        logm = jnp.where(pos, jnp.log(jnp.where(pos, m, 1.0)), jnp.nan)
        med = jnp.nanmedian(logm)
        dev = jnp.nanmedian(jnp.abs(logm - med))
        cutoff = jnp.exp(med - mad_max * dev)
        mask = mask & (m >= cutoff)

    b0 = jnp.where(mask, 1.0, 0.0).astype(band.dtype)

    def cond(state):
        b, var, it = state
        return (var >= tol) & (it < max_iters)

    def body(state):
        b, _, it = state
        m = _sym_marginal(band, b, L)
        nzm = m > 0
        cnt = jnp.maximum(jnp.sum(nzm), 1)
        mean = jnp.sum(jnp.where(nzm, m, 0.0)) / cnt
        rel = jnp.where(nzm, m / mean, 1.0)
        b = b / rel
        var = jnp.sum(jnp.where(nzm, (m / mean - 1.0) ** 2, 0.0)) / cnt
        return b, var, it + 1

    b, var, it = jax.lax.while_loop(cond, body, (b0, jnp.inf, 0))
    # rescale so the balanced matrix's nonzero marginals average 1
    m = _sym_marginal(band, b, L)
    nzm = m > 0
    cnt = jnp.maximum(jnp.sum(nzm), 1)
    scale = jnp.sum(jnp.where(nzm, m, 0.0)) / cnt
    b = b / jnp.sqrt(jnp.where(scale > 0, scale, 1.0))
    return b, mask, var, it, scale


def ice_balance_chrom(raw_band, L, ignore_diags=1, mad_max=5, min_nnz=10,
                      min_count=0, tol=1e-5, max_iters=200,
                      device=None) -> IceResult:
    """Balance one chromosome band; returns cooler-convention weights
    (NaN at filtered bins) of length L.  ``device`` pins the computation
    (e.g. a CPU device for ingestion-time balancing)."""
    if device is not None:
        band = jax.device_put(np.asarray(raw_band), device)
    else:
        band = jnp.asarray(raw_band)
    b, mask, var, it, scale = _ice_device(band, L, ignore_diags, min_nnz,
                                          min_count, mad_max, tol, max_iters)
    b = np.asarray(b, np.float64)[:L]
    mask = np.asarray(mask)[:L]
    weights = np.where(mask & (b > 0), b, np.nan)
    n_iters = int(it)
    varf = float(var)
    return IceResult(bias=weights, var=varf, converged=varf < tol,
                     n_iters=n_iters, scale=float(scale))


@functools.partial(jax.jit, static_argnames=('n_bins', 'ignore_diags',
                                             'min_nnz', 'min_count',
                                             'mad_max', 'max_iters'))
def _ice_coo_device(bin1, bin2, count, n_bins, ignore_diags, min_nnz,
                    min_count, mad_max, tol, max_iters):
    """Genome-wide (trans-inclusive) iterative correction over a COO pixel
    list.  Marginals are scatter-adds over genome-wide bin ids — each stored
    upper-triangle pixel contributes to both its row and its column bin
    (diagonal once), which is exactly the symmetric matvec ``S @ b``.

    ``ignore_diags`` masks by genome-wide id distance, matching cooler's
    chunk filter; with the default ignore_diags=1 only the main diagonal
    (always intra-chromosomal) is dropped."""
    count = jnp.where(bin2 - bin1 < ignore_diags, 0.0, count)
    offdiag = bin1 != bin2

    def marginal(b):
        v = count * b[bin1] * b[bin2]
        m = jnp.zeros(n_bins, count.dtype).at[bin1].add(v)
        return m.at[bin2].add(jnp.where(offdiag, v, 0.0))

    nz = (count != 0).astype(count.dtype)
    nnz = jnp.zeros(n_bins, count.dtype).at[bin1].add(nz)
    nnz = nnz.at[bin2].add(jnp.where(offdiag, nz, 0.0))
    marg0 = marginal(jnp.ones(n_bins, count.dtype))

    mask = jnp.ones(n_bins, bool)
    if min_nnz > 0:
        mask = mask & (nnz >= min_nnz)
    if min_count > 0:
        mask = mask & (marg0 >= min_count)
    if mad_max > 0:
        m = jnp.where(mask, marg0, 0.0)
        pos = m > 0
        logm = jnp.where(pos, jnp.log(jnp.where(pos, m, 1.0)), jnp.nan)
        med = jnp.nanmedian(logm)
        dev = jnp.nanmedian(jnp.abs(logm - med))
        cutoff = jnp.exp(med - mad_max * dev)
        mask = mask & (m >= cutoff)

    b0 = jnp.where(mask, 1.0, 0.0).astype(count.dtype)

    def cond(state):
        b, var, it = state
        return (var >= tol) & (it < max_iters)

    def body(state):
        b, _, it = state
        m = marginal(b)
        nzm = m > 0
        cnt = jnp.maximum(jnp.sum(nzm), 1)
        mean = jnp.sum(jnp.where(nzm, m, 0.0)) / cnt
        rel = jnp.where(nzm, m / mean, 1.0)
        b = b / rel
        var = jnp.sum(jnp.where(nzm, (m / mean - 1.0) ** 2, 0.0)) / cnt
        return b, var, it + 1

    b, var, it = jax.lax.while_loop(cond, body, (b0, jnp.inf, 0))
    m = marginal(b)
    nzm = m > 0
    cnt = jnp.maximum(jnp.sum(nzm), 1)
    scale = jnp.sum(jnp.where(nzm, m, 0.0)) / cnt
    b = b / jnp.sqrt(jnp.where(scale > 0, scale, 1.0))
    return b, mask, var, it, scale


def ice_balance_genome(bin1, bin2, count, n_bins, ignore_diags=1, mad_max=5,
                       min_nnz=10, min_count=0, tol=1e-5, max_iters=200,
                       device=None) -> IceResult:
    """Trans-inclusive balancing over the genome-wide pixel list (the
    reference's ``cis_only=False`` branch, utilities.py:398-417 with
    ``onlyIntra='False'`` metadata); returns cooler-convention weights of
    length ``n_bins``."""
    dtype = np.float64 if device is not None else np.float32
    arrs = (np.asarray(bin1, np.int32), np.asarray(bin2, np.int32),
            np.asarray(count, dtype))
    if device is not None:
        arrs = tuple(jax.device_put(a, device) for a in arrs)
    b, mask, var, it, scale = _ice_coo_device(
        *arrs, n_bins, ignore_diags, min_nnz, min_count, mad_max, tol,
        max_iters)
    b = np.asarray(b, np.float64)
    mask = np.asarray(mask)
    weights = np.where(mask & (b > 0), b, np.nan)
    varf = float(var)
    return IceResult(bias=weights, var=varf, converged=varf < tol,
                     n_iters=int(it), scale=float(scale))


def _balance_device():
    """(device, dtype) balancing runs with: the host CPU backend and a
    float64 request (the reference's ICE is double precision), since
    balancing is ingestion-time work and the peak callers own the
    accelerator.  Without ``jax_enable_x64`` the float64 request
    silently runs in float32."""
    return jax.devices('cpu')[0], np.float64


def balance_chrom_pixels(b1, b2, ct, L, ignore_diags=1, mad_max=5, min_nnz=10,
                         min_count=0, tol=1e-5, max_iters=200):
    """ICE weights of one chromosome from its chromosome-local
    upper-triangle pixels — the per-chromosome unit of the cis-only
    :func:`balance`, usable without a cooler file.  Returns
    (weights [L] with NaN at filtered bins, converged).

    COO sweeps with power-of-two padding: the dense-band form costs one
    XLA compile per chromosome SHAPE and streams a dense [L, L] band per
    iteration; the COO form is O(nnz) per sweep and every same-bucket
    chromosome shares one program.  Zero-count padding pixels and empty
    padding bins are inert: counts of 0 contribute nothing to
    marginals/nnz, and bins with zero marginal never enter the
    mean/variance (nzm) nor survive the min_nnz/MAD filters, exactly as
    real empty bins."""
    device, dtype = _balance_device()
    nnz_pad = 1024
    while nnz_pad < max(1, len(ct)):
        nnz_pad *= 2
    L_pad = 1024
    while L_pad < L:
        L_pad *= 2
    b1p = np.zeros(nnz_pad, np.int32)
    b2p = np.zeros(nnz_pad, np.int32)
    ctp = np.zeros(nnz_pad, dtype)
    b1p[:len(b1)] = b1
    b2p[:len(b2)] = b2
    ctp[:len(ct)] = ct
    result = ice_balance_genome(b1p, b2p, ctp, L_pad,
                                ignore_diags=ignore_diags, mad_max=mad_max,
                                min_nnz=min_nnz, min_count=min_count,
                                tol=tol, max_iters=max_iters, device=device)
    return result.bias[:L], result.converged


def balance(clr, nproc=1, chunksize=int(1e7), mad_max=5, min_nnz=10,
            min_count=0, ignore_diags=1, tol=1e-5, max_iters=200,
            weight_name='weight', cis_only=None):
    """Balance a cooler group and persist bins/weight, mirroring the
    reference ``balance()`` entry point (utilities.py:367-431).  Like the
    reference, ``cis_only`` defaults to the cooler's ``onlyIntra`` metadata
    (utilities.py:398-402): intra-only files get independent per-chromosome
    correction; trans-inclusive files get one genome-wide correction.
    ``nproc``/``chunksize`` are accepted for CLI compatibility; the device
    path needs neither."""
    if cis_only is None:
        meta = clr.info.get('metadata') or {}
        cis_only = str(meta.get('onlyIntra', 'True')) == 'True'
    res = clr.binsize
    weights = []
    stats = {'tol': tol, 'min_nnz': min_nnz, 'min_count': min_count,
             'mad_max': mad_max, 'cis_only': bool(cis_only),
             'ignore_diags': ignore_diags, 'converged': True}
    device, dtype = _balance_device()
    if not cis_only:
        b1, b2, ct = clr.pixels()
        result = ice_balance_genome(b1, b2, ct, clr.nbins,
                                    ignore_diags=ignore_diags,
                                    mad_max=mad_max, min_nnz=min_nnz,
                                    min_count=min_count, tol=tol,
                                    max_iters=max_iters, device=device)
        stats['converged'] = result.converged
        clr.write_weights(result.bias, stats, name=weight_name)
        return stats

    def _one(chrom):
        b1, b2, ct = clr.pixels_for_chrom(chrom)
        lo, hi = clr.bin_range(chrom)
        return balance_chrom_pixels(b1, b2, ct, hi - lo,
                                    ignore_diags=ignore_diags,
                                    mad_max=mad_max, min_nnz=min_nnz,
                                    min_count=min_count, tol=tol,
                                    max_iters=max_iters)

    # chromosomes balance independently (the reference farms them to a
    # Pool, utilities.py:392-396); XLA CPU executions release the GIL, so
    # a small thread pool overlaps them with zero per-process copies.
    # Results are deterministic regardless of completion order.  Worker
    # count is bounded by a ~2GB in-flight budget (each chromosome holds
    # roughly 64 bytes/pixel across the padded COO arrays and jit
    # buffers) so deep high-resolution genomes stay within the
    # reference's memory envelope (README.rst:291: <3.0G at K562 10Kb).
    from concurrent.futures import ThreadPoolExecutor
    max_nnz = 1
    for chrom in clr.chromnames:
        lo, hi = clr.bin_range(chrom)
        b1o = clr.pixel_count_for_chrom(chrom) if hasattr(
            clr, 'pixel_count_for_chrom') else None
        if b1o is None:
            # cheap upper bound from the bin1 index, no pixel read
            from ..io.coolerlite import _h5file
            with _h5file(clr.path, 'r') as h5:
                idx = h5[clr.group]['indexes/bin1_offset']
                b1o = int(idx[hi]) - int(idx[lo])
        max_nnz = max(max_nnz, int(b1o))
    budget_workers = max(1, int(2e9 // (64 * max_nnz)))
    workers = min(4, budget_workers, max(1, len(clr.chromnames)))
    with ThreadPoolExecutor(workers) as ex:
        outs = list(ex.map(_one, clr.chromnames))
    for bias, conv in outs:
        stats['converged'] = bool(stats['converged'] and conv)
        weights.append(bias)
    clr.write_weights(np.concatenate(weights), stats, name=weight_name)
    return stats
