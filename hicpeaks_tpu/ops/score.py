"""On-device statistical scoring.

Implements, over dense band tensors, the reference's per-(p,w) scoring
stage (callers.py:239-317 for hiccups, callers.py:517-577 for bhfdr):

* corrected expected values  E = IR[d] * (bS/bE) * B1[x] * B2[y]
  (invariant 3 of SURVEY §2)
* lambda chunking at 2^(1/3) multiplicative steps with p-values against
  the chunk's right edge (callers.py:25-41, 268-270)
* Poisson survival via the regularized lower incomplete gamma:
  1 - PoissonCDF(k; lam) = P(k+1, lam)
* per-chunk Benjamini-Hochberg — statsmodels' fdr_bh semantics on device
  (replacing the statsmodels dependency, callers.py:11,273-275) — in two
  flavours: a sort-free (chunk, count) histogram for the chunked path
  (`chunk_bh_histogram`, the production path) and a multi-key-sort
  implementation for continuous-lambda BH (`segmented_bh`)
* gap filtering with the reference's exact (exclusive-upper) window ranges
  (callers.py:291-312)
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.scipy.special import gammainc


def shear_bcast(vec, num_p):
    """out[d, x] = vec[x + d], zero beyond the end — gather-free.

    The shear is built from pure broadcasts and reshapes instead of a
    2-D gather: tile ``wpad = [vec, 0...]`` (length M = Lp + num_p)
    flat, then re-read it with row stride M+1 — row d starts one element
    later per row, i.e. H[d, x] = wpad[x + d].  No wraparound is possible
    because x + d <= (Lp-1) + (num_p-1) < M."""
    Lp = vec.shape[0]
    M = Lp + num_p
    wpad = jnp.concatenate([vec, jnp.zeros(num_p, vec.dtype)])
    flat = jnp.broadcast_to(wpad, (num_p + 1, M)).reshape(-1)
    return flat[:num_p * (M + 1)].reshape(num_p, M + 1)[:, :Lp]


def bias_product_host(bias, num_p):
    """Host-side precompute of Bprod[d, x] = B1[x] * B2[x+d] (the two
    inverse-ICE factors of invariant 3).  Built with numpy stride tricks so
    the device graph carries no 2-D gather."""
    import numpy as np
    b = np.asarray(bias)
    Lp = b.shape[0]
    padded = np.concatenate([b, np.zeros(num_p, b.dtype)])
    By = np.lib.stride_tricks.sliding_window_view(padded, Lp)[:num_p]
    return np.ascontiguousarray(By * b[None, :])


def _unpack_rows(a, bits):
    """Inverse of engine._pack_rows: sub-byte packed count rows -> f32.

    Byte j holds original columns j*per + k at bit offset bits*k; the
    shift/mask/stack/reshape chain is pure elementwise + a trailing-axis
    collapse — no gathers."""
    if bits is None or bits >= 8:
        return a.astype(jnp.float32)
    per = 8 // bits
    mask = (1 << bits) - 1
    segs = [(a >> (bits * k)) & mask for k in range(per)]
    x = jnp.stack(segs, axis=-1)
    return x.reshape(a.shape[0], a.shape[1] * per).astype(jnp.float32)


def build_sheets_device(raw, w0, bias, IR, gap, ww_min, L, d_lo, d_hi,
                        gap_s, bits=None):
    """Jitted device-side derivation of every dense sheet the engine needs
    from one raw slab + O(L) vectors.

    Replaces the round-1 host path that built and shipped four extra
    dense [num_p, Lp] sheets per chromosome (balanced band, expected
    band, bias product, gap-reject — ~400MB of host→device transfer at
    genome scale):

    * cband[d,x] = raw * w0[x] * w0[x+d], rows < ww_min zeroed — the
      balanced band (w0 has invalid bins zeroed, so NaN-weight pixels
      land on 0 exactly like the host's NaN masking, band.py)
    * eband[d,x] = IR[d] on the true extent x < L-d (engine._band_arrays'
      former eband_np)
    * Bprod[d,x] = bias[x] * bias[x+d] (bias_product_host twin)
    * gap_drop   = gap_reject_device(gap, ...) (gap_reject_host twin)
    * cand[d,x]  = raw != 0 within d_lo <= d <= d_hi (engine._candidates)

    ``raw`` may arrive as uint16 or uint8 (integer Hi-C counts — the
    engine halves or quarters the slab transfer that way), or as a
    (uint16 head rows, uint8 tail rows) pair exploiting the steep
    count decay with genomic distance (engine._compact_slab); the float32
    slab every downstream kernel consumes is rebuilt on device and
    returned first.
    """
    if isinstance(raw, (tuple, list)):
        raw = tuple(raw)
        if bits is None:
            bits = (None,) * len(raw)
    # L stays a traced operand (it may already be a tracer when this runs
    # inside the fused chromosome program): chromosomes of one shape
    # bucket share the compiled executable across different logical
    # lengths
    # d_hi stays a traced operand (like L): it is the only per-resolution
    # value in the sheet derivation, so tracing it lets a multi-resolution
    # run share one executable across 5/10/25Kb (row-bucketed bands)
    return _build_sheets_jit(raw, w0, bias, IR, gap, ww_min=int(ww_min),
                             L=L, d_lo=int(d_lo), d_hi=d_hi,
                             gap_s=int(gap_s),
                             bits=tuple(bits) if bits is not None else None)


@functools.partial(jax.jit, static_argnames=('ww_min', 'd_lo',
                                             'gap_s', 'bits'))
def _build_sheets_jit(raw, w0, bias, IR, gap, ww_min, L, d_lo, d_hi,
                      gap_s, bits=None):
    if isinstance(raw, tuple):
        # row-classed transfer encoding: unpack each row range and
        # concatenate back to one slab on device (the cast + concat fuses
        # into the consumers)
        raw = jnp.concatenate(
            [_unpack_rows(r, b) for r, b in zip(raw, bits)], axis=0) \
            if len(raw) > 1 else _unpack_rows(raw[0], bits[0])
    num_p, Lp = raw.shape
    drow = jnp.arange(num_p)[:, None]
    col = jnp.arange(Lp)[None, :]

    raw = raw.astype(jnp.float32)
    cband = raw * w0[None, :] * shear_bcast(w0, num_p)
    cband = jnp.where(drow < ww_min, 0.0, cband)
    eband = jnp.where(col < (L - drow), IR[:, None], 0.0)
    Bprod = bias[None, :] * shear_bcast(bias, num_p)
    gap_drop = gap_reject_device(gap, num_p, L, gap_s)
    cand = (raw != 0) & (drow >= d_lo) & (drow <= d_hi)
    return raw, cband, eband, Bprod, gap_drop, cand


def expected_observed(raw, cband, IR, Bprod, bSV, bEV, wi, cand_mask, L):
    """E, O, ICE, Fold, scored mask, and the raw EM*ratio product (needed by
    the hiccups Y-background postcheck, callers.py:329-331).
    ``Bprod`` is the host-precomputed B1[x]*B2[y] sheet."""
    num_p = raw.shape[0]
    drow = jnp.arange(num_p)[:, None]
    col = jnp.arange(raw.shape[1])[None, :]
    colvalid = col < (L - drow)
    EM = jnp.where(colvalid, IR[:, None], 0.0)

    mask = (bEV != 0) & (drow >= wi) & cand_mask
    ratio = jnp.where(mask, bSV / jnp.where(bEV != 0, bEV, 1.0), 0.0)
    prod = EM * ratio

    E = prod * Bprod
    scored = (prod != 0) & (E > 0)
    O = raw
    ICE = cband
    Fold = jnp.where(scored, O / jnp.where(scored, E, 1.0), 0.0)
    return E, O, ICE, Fold, scored, prod


def poisson_sf(O, lam):
    """P(X > O) for X ~ Poisson(lam), X's CDF evaluated at floor(O)."""
    return gammainc(jnp.floor(O) + 1.0, lam)


def lambda_chunks(E, scored):
    """Chunk id per pixel: chunk i covers the OPEN interval
    (2^((i-2)/3), 2^((i-1)/3)), chunk 1 is (0, 1).  Pixels exactly on a
    boundary belong to no chunk (callers.py:38 uses strict inequalities) and
    keep p = q = 1.  Returns (cid, right_edge, valid)."""
    safeE = jnp.where(scored & (E > 0), E, 1.0)
    t = 3.0 * (jnp.log(safeE) / jnp.log(2.0))
    cid = jnp.floor(t).astype(jnp.int32) + 2
    cid = jnp.maximum(cid, 1)
    # float-rounding guard: nudge into the neighbouring chunk when the
    # computed id misses the strict-open membership test
    lv = jnp.where(cid == 1, 0.0, jnp.power(2.0, (cid - 2) / 3.0))
    rv = jnp.power(2.0, (cid - 1) / 3.0)
    cid = jnp.where((safeE <= lv) & (cid > 1), cid - 1,
                    jnp.where(safeE >= rv, cid + 1, cid))
    lv = jnp.where(cid == 1, 0.0, jnp.power(2.0, (cid - 2) / 3.0))
    rv = jnp.power(2.0, (cid - 1) / 3.0)
    valid = scored & (safeE > lv) & (safeE < rv)
    return cid, rv, valid


def lambda_suspects(E, scored, margin):
    """Pixels whose f32 lambda-chunk membership is not PROVABLY the
    float64 one: ``t = 3*log2(E)`` within ``margin`` of an integer (chunk
    edges sit exactly at integer t, :func:`lambda_chunks`).

    The reference chunks float64 E values (callers.py:263-270); the
    device's f32 E carries the ring-sum accumulation error, so a pixel
    within that error of a chunk edge may land in the adjacent chunk —
    shifting that chunk's m/rank by one and every q in it by ~1/m (the
    round-2 verdict's residual 2.8e-4 stat drift).  The engine compacts
    these suspects, replays their E in exact float64 on the host
    (ops/hostexact), corrects the integer histogram, and decides their
    keep/stats host-side.  ``margin`` must bound |t_f32 - t_f64|; the
    engine derives it from the window cell count (engine._chunk_margin)."""
    safeE = jnp.where(scored & (E > 0), E, 1.0)
    t = 3.0 * (jnp.log(safeE) / jnp.log(2.0))
    return scored & (jnp.abs(t - jnp.round(t)) < margin)


_SCAN_ROW = 8192   # row width for two-level scans (see _cummax_2l)


def _two_level(x, scan_fn, identity, reverse=False):
    """Scan a long 1-D array as [rows, _SCAN_ROW] row scans + a tiny
    cross-row carry (the same values as one flat scan; the reshaped form
    keeps the compiled scan's size independent of n)."""
    n = x.shape[0]
    C = _SCAN_ROW
    if n <= C:
        return scan_fn(x[::-1])[::-1] if reverse else scan_fn(x)
    B = -(-n // C)
    xp = jnp.pad(x, (0, B * C - n), constant_values=identity)
    if reverse:
        xp = xp[::-1]
    X = xp.reshape(B, C)
    row = scan_fn(X)                      # scan along axis 1
    tails = row[:, -1]
    carry = scan_fn(tails[None, :])[0]    # prefix over row tails
    carry = jnp.concatenate([jnp.full(1, identity, x.dtype), carry[:-1]])
    if scan_fn is _cmax:
        out = jnp.maximum(row, carry[:, None])
    else:
        out = jnp.minimum(row, carry[:, None])
    out = out.reshape(-1)
    if reverse:
        out = out[::-1]
    return out[:n]


def _cmax(a):
    return jax.lax.cummax(a, axis=a.ndim - 1)


def _cmin(a):
    return jax.lax.cummin(a, axis=a.ndim - 1)


def _cumsum_2l(x):
    n = x.shape[0]
    C = _SCAN_ROW
    if n <= C:
        return jnp.cumsum(x)
    B = -(-n // C)
    X = jnp.pad(x, (0, B * C - n)).reshape(B, C)
    row = jnp.cumsum(X, axis=1)
    carry = jnp.concatenate([jnp.zeros(1, x.dtype),
                             jnp.cumsum(row[:, -1])[:-1]])
    return (row + carry[:, None]).reshape(-1)[:n]


def _seg_suffix_min(vals, first):
    """Exact within-segment suffix-min of ``vals`` where ``first`` marks
    segment starts (arrays in sorted-segment order).

    Reversed, this is a forward *segmented* cummin with resets at the
    original segment-last positions.  The combine
    ``(m1,f1) op (m2,f2) = (m2 if f2 else min(m1,m2), f1|f2)`` is
    associative, so it runs as a two-level scan: an associative_scan along
    rows of a [B, _SCAN_ROW] reshape plus a tiny cross-row carry — the same
    shape as the plain two-level scans.  Bit-exact: a min never creates new values, so no
    precision caveat at any segment count (ADVICE r1 on the former
    ordinal-offset formulation)."""
    n = vals.shape[0]
    # reset[i] (reversed order) = original `last` = first shifted left
    last = jnp.concatenate([first[1:], jnp.ones(1, bool)])
    v = vals[::-1]
    r = last[::-1]

    def comb(a, b):
        m1, f1 = a
        m2, f2 = b
        return jnp.where(f2, m2, jnp.minimum(m1, m2)), f1 | f2

    C = _SCAN_ROW
    if n <= C:
        m, _ = jax.lax.associative_scan(comb, (v, r))
        return m[::-1]
    B = -(-n // C)
    vp = jnp.pad(v, (0, B * C - n), constant_values=jnp.inf).reshape(B, C)
    rp = jnp.pad(r, (0, B * C - n)).reshape(B, C)
    row_m, row_f = jax.lax.associative_scan(comb, (vp, rp), axis=1)
    # carry into row b = segmented scan over previous rows' tails
    tail_m, tail_f = row_m[:, -1], row_f[:, -1]
    cm, _ = jax.lax.associative_scan(comb, (tail_m[None, :],
                                            tail_f[None, :]), axis=1)
    carry = jnp.concatenate([jnp.full(1, jnp.inf, vals.dtype), cm[0, :-1]])
    # the carry applies only until the first reset inside the row
    out = jnp.where(row_f, row_m, jnp.minimum(row_m, carry[:, None]))
    return out.reshape(-1)[::-1][B * C - n:]


def compact_mask(keep, cap):
    """Row-major indices of the first ``cap`` True cells of a [R, C] mask.

    A static-size alternative to ``jnp.nonzero``: a two-level reshaped
    cumsum plus a hierarchical search — binary-search the per-block
    tails to find each target's block, gather those blocks ([cap, block]
    rows), and count entries below the target inside them (the same
    indices as a flat [cap, n] search at a fraction of its work).

    Returns (true_count, row_idx, col_idx); entries past ``true_count``
    point at the last cell and must be sliced off by the caller.
    """
    # Miscompile guard (seen with jax 0.8.x on the accelerator this
    # engine was first built for): when the producer of ``keep`` is a
    # large fused broadcast-reduce (the chunk_bh_keep threshold sum), XLA
    # rematerialized it inside the cumsum's fusion with DIFFERENT (wrong)
    # values — jnp.sum(keep) said 61 while csum[-1] said 39948 in the
    # same program.  The barrier forces one materialization of ``keep``
    # so every consumer sees the same bits.  Cost: one [R, C] bool
    # buffer round-trip.
    keep = jax.lax.optimization_barrier(keep)
    R, C = keep.shape
    n = R * C
    csum = _cumsum_2l(keep.reshape(-1).astype(jnp.int32))
    # block width: the inner count costs cap*block compares + a
    # [cap, block] row gather, so shrink blocks for the large retry caps
    W = 512 if cap <= (1 << 14) else 128
    nb = -(-n // W)
    # edge-mode pad replicates csum[-1] WITHOUT a scalar index into the
    # flat n-element cumsum (such an index made XLA emit a far larger
    # program for this routine); cnt reads the same materialized cumsum
    # through the 2-D view.
    cs_b = jnp.pad(csum, (0, nb * W - n), mode='edge').reshape(nb, W)
    cnt = cs_b[-1, -1]
    targets = jnp.arange(1, cap + 1, dtype=jnp.int32)
    b = jnp.minimum(jnp.searchsorted(cs_b[:, -1], targets, side='left'),
                    nb - 1)
    inner = jnp.sum(cs_b[b] < targets[:, None], axis=1)
    pos = jnp.minimum(b * W + inner, n - 1)
    return cnt, (pos // C).astype(jnp.int32), (pos % C).astype(jnp.int32)


def compact_mask_batched(keep, cap):
    """vmap-free batched :func:`compact_mask` over a leading [B] axis.

    Row-for-row identical results (same two-level integer cumsum, same
    hierarchical block search), but every stage lowers as a plain batched
    op instead of through vmap's batching rules.  The zero-pad of the INPUT reproduces the unbatched
    form's edge-mode pad of the cumsum (trailing cumsum entries replicate
    the total either way).

    Returns (true_count [B], row_idx [B, cap], col_idx [B, cap])."""
    keep = jax.lax.optimization_barrier(keep)
    B, R, C = keep.shape
    n = R * C
    W = 512 if cap <= (1 << 14) else 128
    nb = -(-n // W)
    X = jnp.pad(keep.reshape(B, n).astype(jnp.int32),
                ((0, 0), (0, nb * W - n)))
    row = jnp.cumsum(X.reshape(B, nb, W), axis=2)
    tails = row[:, :, -1]
    carry = jnp.cumsum(tails, axis=1) - tails          # exclusive prefix
    cs_b = row + carry[:, :, None]
    cnt = cs_b[:, -1, -1]
    targets = jnp.arange(1, cap + 1, dtype=jnp.int32)
    b_idx = jnp.minimum(
        jax.vmap(lambda t: jnp.searchsorted(t, targets, side='left'))(
            cs_b[:, :, -1]),
        nb - 1)
    rows_g = jnp.take_along_axis(cs_b, b_idx[:, :, None], axis=1)
    inner = jnp.sum(rows_g < targets[None, :, None], axis=2)
    pos = jnp.minimum(b_idx * W + inner, n - 1)
    return cnt, (pos // C).astype(jnp.int32), (pos % C).astype(jnp.int32)


def segmented_bh(pvals, seg, valid):
    """Benjamini-Hochberg q-values within each segment of ``seg`` (int ids),
    restricted to ``valid``; invalid entries get q = 1.

    Matches statsmodels multipletests(method='fdr_bh'): within a segment of
    size m, q = cummin-from-largest(p_sorted * m / rank), clipped to 1.

    Engineering notes (compile cost): one multi-key lax.sort instead of
    two argsorts; all running extrema via two-level reshaped scans; the
    segmented suffix-min via an exact pair-scan (_seg_suffix_min).
    """
    shape = pvals.shape
    p = pvals.ravel()
    n = p.size
    BIG = jnp.int32(2 ** 30)
    s = jnp.where(valid.ravel(), seg.ravel().astype(jnp.int32), BIG)

    idx0 = jnp.arange(n, dtype=jnp.int32)
    ss, ps, perm = jax.lax.sort((s, p, idx0), num_keys=2)
    idx = jnp.arange(n)

    first = jnp.concatenate([jnp.ones(1, bool), ss[1:] != ss[:-1]])
    last = jnp.concatenate([first[1:], jnp.ones(1, bool)])
    seg_start = _two_level(jnp.where(first, idx, 0), _cmax, 0)
    seg_end = _two_level(jnp.where(last, idx, n), _cmin, n, reverse=True)
    m = (seg_end - seg_start + 1).astype(ps.dtype)
    rank = (idx - seg_start + 1).astype(ps.dtype)
    qc = jnp.minimum(ps * m / rank, 1.0)

    q = _seg_suffix_min(qc, first)

    out = jnp.zeros(n, ps.dtype).at[perm].set(q)
    out = jnp.where(valid.ravel(), out, 1.0)
    return out.reshape(shape)


def chunk_rows(o_cap, sig=0.05):
    """Static chunk-row count sufficient for EXACT histogram BH at this
    count cap — the fold that cuts the (chunk, count) histogram's rows
    ~3x.

    Chunk id i covers E in the open interval (2^((i-2)/3), 2^((i-1)/3))
    (:func:`lambda_chunks`) and its p-values are evaluated at the RIGHT
    edge rv = 2^((i-1)/3) (callers.py:268-270).  Any chunk whose rv is
    >= 2*o_cap can never emit a kept pixel: every observable count
    O <= o_cap <= rv/2 sits far below the rate, so its p-value
    1 - cdf(O; rv) >= 1 - P(X <= rv/2 | rv) >= 1 - exp(-0.15*rv), i.e.
    p = 1 within ~1e-60 at o_cap >= 1024, and BH's q >= p > sig.  Folding
    every such chunk into one shared overflow row S-1 (whose own rv
    satisfies the same bound by construction: S-1 >= 3*log2(o_cap) + 4)
    therefore changes no emitted statistic — rows 1..S-2 keep their exact
    populations (BH is per-chunk), and the overflow row's mixed
    population is only ever read by pixels that provably cannot pass the
    significance test, on the device (count threshold = C) or in the
    float64 host completion.

    Guarded on ``sig <= 0.2`` (the proof needs sig < 1 - 1e-60; 0.2
    leaves astronomic margin while covering every realistic run — the
    reference defaults are 0.05/0.1) and on o_cap >= 1024 (the engine's
    minimum bucket).  Returns a multiple of 8, at most 128."""
    import math
    if not o_cap or o_cap < 1024 or sig > 0.2:
        return 128
    s = int(math.ceil(3 * math.log2(o_cap))) + 5
    return min(128, -(-s // 8) * 8)


def chunk_bh_histogram(O, cid, valid, n_chunks=128, o_cap=32768):
    """Sort-free Benjamini-Hochberg for the lambda-chunked path — the
    north-star 'on-device lambda-chunk histogramming'.

    Within a chunk every pixel's p-value is ``sf(floor(O); right_edge)``,
    a function of the integer part of the raw count alone, so p-values are
    massively tied and BH collapses onto the (chunk, count) histogram:

      rank_max(s, O) = #{pixels in s with count >= O}     (suffix-sum)
      qraw(s, O)     = clip(p(s, O) * m_s / rank_max, 1)
      q(s, O)        = prefix-min over ascending O         (the reverse
                        running-min of the sorted order, tie groups whole)

    Tie groups sharing q makes this EXACTLY statsmodels' fdr_bh (tied
    p-values always emerge from the final cummin with a common value).
    Counts above ``o_cap`` share the cap bucket; choose the cap so the
    survival function has underflowed to 0 there (identical p = identical
    tie group), or fall back to the sort path.

    Returns the dense q array (1 at invalid pixels).
    """
    shape = O.shape
    S, C = n_chunks, o_cap + 1
    Oc_p, cid_p, n = _chunk_pack(O, cid, valid, S, C)
    qtab, _ = _chunk_qtab(Oc_p, cid_p, S, C, O.dtype)
    s_iota = jnp.arange(S, dtype=jnp.int32)
    c_iota = jnp.arange(C, dtype=jnp.int32)

    def lookup_step(_, xs):
        # HIGHEST precision: a default-precision f32 matmul may round its
        # operands (bf16 passes, or TF32 on tensor cores), which rounds
        # the selected q to ~3 digits; at HIGHEST the one-hot picks the
        # qtab entry bit-exactly (invalid pixels read trash row 0, masked
        # below)
        oc, cc = xs
        oh_s = (cc[:, None] == s_iota[None, :]).astype(O.dtype)
        oh_o = (oc[:, None] == c_iota[None, :]).astype(O.dtype)
        rows = jnp.dot(oh_s, qtab, preferred_element_type=O.dtype,
                       precision=jax.lax.Precision.HIGHEST)
        q = jnp.sum(rows * oh_o, axis=1)
        return None, q

    _, q_chunks = jax.lax.scan(lookup_step, None, (Oc_p, cid_p))
    q = q_chunks.reshape(-1)[:n]
    q = jnp.where(valid.ravel(), q, 1.0)
    return q.reshape(shape).astype(O.dtype)


def chunk_bh_keep(O, cid, valid, sig, n_chunks=128, o_cap=32768,
                  slack=0.0, mesh=None, hcap=None):
    """``(chunk_bh_histogram(...) <= sig)`` without the per-pixel q lookup.

    ``qtab`` is a cummin over ascending integer counts, so within a chunk
    q is nonincreasing in the count and ``q <= sig`` is equivalent to
    ``count >= thr[chunk]`` where ``thr[s]`` counts the leading qtab
    entries above ``sig``; ``thr[cid]`` is a gather from the [S] table.
    (Looking up the already-decided ``cid``, not comparing E against
    chunk-edge powers, keeps the collapse exact even where
    ``jnp.power(2, k/3)`` rounds differently between XLA programs.)  The
    whole decision is one elementwise pass over the sheet — the
    [pixels, o_cap] f32 selection matmul of the dense lookup
    (S*pixels*o_cap MACs) is deferred to the compacted keep set via the
    returned table.  All arithmetic is exact: thr holds integers < 2^24.

    ``slack > 0`` inflates the significance level used for the count
    threshold (``sig * (1 + slack)``) so the mask is a guaranteed SUPERSET
    of the float64 rejection set: the f32 qtab's only inexact term is the
    f32 ``gammainc`` evaluation of ptab (m and rank_max are exact integers
    and the cummin creates no new values), whose relative error near
    moderate p-values is far below 1e-2.  The engine recomputes exact
    float64 p/q for the compacted pixels from the returned integer
    histogram (:func:`host_chunk_complete`) and filters with the true
    ``sig`` — reference semantics (callers.py:263-287) in full float64.

    Returns (keep mask, qtab [n_chunks, o_cap+1], hist [n_chunks, o_cap+1]
    int32, thr [n_chunks] — the per-chunk first-significant count index
    the mask compared against, shipped to the controller so it can verify
    the superset property against the suspect-CORRECTED float64 table);
    look up f32 q-values for compacted pixels as ``qtab[cid, floor(O)]``
    (invalid pixels carry q = 1, which this mask admits only when
    ``sig >= 1``).

    ``hcap`` enables the split histogram (:func:`chunk_hist_split`) when
    C is large enough to profit; a fifth returned element ``ok`` is False
    when the high-count tail overflowed (the histogram is then incomplete
    and the caller must retry — the engine folds this into its keep-cap
    overflow ladder).
    """
    S, C = n_chunks, o_cap + 1
    ok = jnp.bool_(True)
    if mesh is not None:
        # sheet sharded along columns: per-shard histogram inside
        # shard_map + one psum (packing a sharded ravel would reshard;
        # the split-histogram optimization is single-device only)
        from ..parallel.tiles import chunk_hist_sharded
        hist = chunk_hist_sharded(O, cid, valid, S, C, mesh)
        qtab = qtab_from_hist(hist, O.dtype)
    elif hcap is not None and C - 1 > 2 * _HIST_T:
        Ocd = jnp.clip(jnp.floor(O).astype(jnp.int32), 0, C - 1)
        cidc0 = jnp.where(valid, jnp.clip(cid, 1, S - 1), 0)
        hist, ok = chunk_hist_split(Ocd, cidc0, S, C, hcap)
        qtab = qtab_from_hist(hist, O.dtype)
    else:
        Oc_p, cid_p, _n = _chunk_pack(O, cid, valid, S, C)
        qtab, hist = _chunk_qtab(Oc_p, cid_p, S, C, O.dtype)
    # first count index with q <= sig, per chunk (C if none)
    thr = (qtab > sig * (1.0 + slack)).astype(O.dtype).sum(axis=1)
    # each pixel's chunk threshold (the clamp matches _chunk_pack's cid
    # clip at S-1)
    th = thr[jnp.clip(cid, 1, S - 1)]
    keep = valid & (jnp.clip(jnp.floor(O), 0, C - 1) >= th)
    # invalid pixels carry q = 1.0, admitted by the mask only when sig >= 1
    keep = keep | (~valid & (jnp.asarray(sig, O.dtype) >= 1.0))
    return keep, qtab, hist, thr.astype(jnp.int32), ok


def chunk_bh_keep_batched(O, cid, valid, sig, B, n_chunks=128, o_cap=32768,
                          slack=0.0, hcap=None):
    """Batched :func:`chunk_bh_keep` over a leading axis of ``B``
    independent backgrounds ([B, num_p, Lp] arrays).

    The (B*S, C) histogram holds every background's table, with row
    ``b*S`` background b's invalid trash row.  This is the anti-unrolling
    form: XLA fully unrolls the per-background scoring bodies of a
    scanned/looped formulation, while everything here but the histogram
    builds is one batched op.

    Returns (keep [B, ...], qtab [B*S, C], hist [B*S, C] int32,
    thr [B, S] int32, ok bool — False when the split histogram's
    high-count tail overflowed ``hcap``; retry unsplit)."""
    S, C = n_chunks, o_cap + 1
    BS = B * S
    ok = jnp.bool_(True)
    # one histogram per background (a static B-loop), the same per-pixel
    # work as the unbatched scorer; everything around them stays batched
    hists = []
    if hcap is not None and C - 1 > 2 * _HIST_T:
        # the observed counts are SHARED across backgrounds (the callers
        # broadcast one raw sheet), so the high-count tail is compacted
        # once and reused per background
        O2 = O if O.ndim == 2 else O[0]
        Ocd = jnp.clip(jnp.floor(O2).astype(jnp.int32), 0, C - 1)
        high = compact_mask(Ocd >= _HIST_T - 1, hcap)
        ok = high[0] <= hcap
        for b in range(B):
            cidc0 = jnp.where(valid[b], jnp.clip(cid[b], 1, S - 1), 0)
            h, _ = chunk_hist_split(Ocd, cidc0, S, C, hcap, high=high)
            hists.append(h)
    else:
        for b in range(B):
            Oc_p, cid_p, _n = _chunk_pack(O[b], cid[b], valid[b], S, C)
            hists.append(chunk_hist(Oc_p, cid_p, S, C))
    hist = jnp.concatenate(hists, axis=0)                     # [B*S, C]
    qtab = qtab_from_hist(hist, O.dtype, period=S)
    thr = (qtab > sig * (1.0 + slack)).astype(O.dtype).sum(axis=1)
    # background b's thresholds are rows [b*S, (b+1)*S) of the table
    row0 = (jnp.arange(B, dtype=jnp.int32) * S)[:, None, None]
    th = thr[row0 + jnp.clip(cid, 1, S - 1)]
    keep = valid & (jnp.clip(jnp.floor(O), 0, C - 1) >= th)
    keep = keep | (~valid & (jnp.asarray(sig, O.dtype) >= 1.0))
    return keep, qtab, hist, thr.astype(jnp.int32).reshape(B, S), ok


def _chunk_pack(O, cid, valid, S, C, pre_offset=False):
    """Flatten and pad (count, chunk, valid) into [steps, CH] scan chunks.

    Invalid (and padded) pixels are folded into chunk row 0 — a trash row
    no valid pixel ever reads (:func:`lambda_chunks` emits cid >= 1), so
    the histogram needs no separate validity mask.  The zero padding up
    to a multiple of the row width CH (:func:`_pack_ch`) lands in the
    (0, 0) trash cell.  ``pre_offset``: cid already carries batched row offsets and validity
    folding (:func:`chunk_bh_keep_batched`).
    """
    Oc = jnp.clip(jnp.floor(O).astype(jnp.int32), 0, C - 1).ravel()
    if pre_offset:
        cidc = cid.ravel()
    else:
        cidc = jnp.where(valid.ravel(), jnp.clip(cid, 1, S - 1).ravel(), 0)
    n = Oc.size
    CH = _pack_ch(C)
    pad = -(-n // CH) * CH - n
    return (jnp.pad(Oc, (0, pad)).reshape(-1, CH),
            jnp.pad(cidc, (0, pad)).reshape(-1, CH), n)


#: Low-count width of the split histogram: counts < _HIST_T-1 go through
#: the dense per-pixel pass over a [S, _HIST_T] table; counts >= _HIST_T-1
#: are compacted and histogrammed exactly in a second small pass, so the
#: dense pass's table width does not grow with o_cap (real-depth Hi-C
#: reaches o_cap 16384).  The high-count tail stays a small fraction of
#: band pixels.
_HIST_T = 512


def _pack_ch(C):
    """Packed-row width for a C-column histogram (shared by every pack)."""
    return max(512, min(32768, ((64 << 20) // (2 * C)) // 256 * 256))


def _pack_ints(Oc, cidc, C):
    """[steps, CH] scan packing of already-clipped integer (count, chunk)
    streams (the int twin of :func:`_chunk_pack`'s tail).  Returns the
    two packed arrays plus the number of zero-pad entries (each lands in
    the (0, 0) trash cell)."""
    Oc = Oc.ravel()
    cidc = cidc.ravel()
    n = Oc.size
    CH = _pack_ch(C)
    pad = -(-n // CH) * CH - n
    return (jnp.pad(Oc, (0, pad)).reshape(-1, CH),
            jnp.pad(cidc, (0, pad)).reshape(-1, CH), pad)


def chunk_hist_split(Ocd, cidc, S, C, hcap, high=None, T=_HIST_T):
    """Exact [S, C] (chunk, count) histogram in two passes.

    * pass 1: counts clipped to T-1 into a [S, T] table;
    * pass 2: pixels with count >= T-1 (concentration: Hi-C counts fall
      off steeply with distance, so these are a sub-percent tail) are
      compacted to at most ``hcap`` indices and histogrammed over columns
      [T-1, C) on the small stream; columns < T-1 of
      pass 1 are untouched by construction, so the concatenation is
      bit-identical to the one-pass histogram.

    ``high``: optional precomputed (cnt_h, d_h, x_h) compaction of the
    ``Ocd >= T-1`` mask — the observed counts are shared across
    backgrounds, so batched callers compact once and reuse.

    Returns (hist [S, C] int32, ok) where ``ok`` is False when the
    high-count tail overflowed ``hcap`` (columns >= T-1 would be
    incomplete; callers must discard the result and retry — the engine
    folds this into its keep-cap overflow ladder)."""
    if high is None:
        high = compact_mask(Ocd >= T - 1, hcap)
    cnt_h, d_h, x_h = high
    ok = cnt_h <= hcap
    OcT = jnp.minimum(Ocd, T - 1)
    lo_o, lo_c, pad_low = _pack_ints(OcT, cidc, T)
    h_low = chunk_hist(lo_o, lo_c, S, T)
    kmask = jnp.arange(hcap, dtype=cnt_h.dtype) < cnt_h
    # masked-off entries point at the last cell; chunk row S is past the
    # table, so they contribute to no bucket (flat single-index gathers)
    flat = d_h * Ocd.shape[1] + x_h
    s_h = jnp.where(kmask, cidc.reshape(-1)[flat], S)
    o_h = jnp.maximum(Ocd.reshape(-1)[flat] - (T - 1), 0)
    hi_o, hi_c, pad_high = _pack_ints(o_h, s_h, C - T + 1)
    h_high = chunk_hist(hi_o, hi_c, S, C - T + 1)
    # reproduce the one-pass histogram's trash cells BIT-EXACTLY: its
    # zero-pad lands in final (0, 0), this path's pads land in (0, 0)
    # (low pass) and (0, T-1) (high pass's own column 0); all three
    # counts are static functions of (n, C, hcap)
    n = Ocd.size
    ch_u = _pack_ch(C)
    pad_u = -(-n // ch_u) * ch_u - n
    h_low = h_low.at[0, 0].add(pad_u - pad_low)
    h_high = h_high.at[0, 0].add(-pad_high)
    return jnp.concatenate([h_low[:, :T - 1], h_high], axis=1), ok


def chunk_hist(Oc_p, cid_p, S, C):
    """Exact int32 [S, C] histogram of the packed (count, chunk) streams:
    one int32 scatter-add over the combined key ``cid * C + count``.
    Chunk ids >= S fall past the table and are dropped (chunk_hist_split
    marks masked-off entries that way)."""
    key = (cid_p.reshape(-1) * C + Oc_p.reshape(-1)).astype(jnp.int32)
    return jnp.zeros(S * C, jnp.int32).at[key].add(
        1, mode='drop').reshape(S, C)


def _chunk_qtab(Oc_p, cid_p, S, C, dtype, period=None):
    """The (chunk, count) BH q table shared by the dense-lookup and
    threshold-mask front ends; returns ``(qtab, hist)`` with ``hist`` the
    exact int32 (chunk, count) histogram the table was built from (the
    engine ships it to the controller for float64 p/q completion).

    Row 0 is a trash row: invalid pixels are folded there by
    :func:`_chunk_pack`, so its m/rank/q entries are garbage-but-finite
    and no valid pixel ever reads them."""
    hist2 = chunk_hist(Oc_p, cid_p, S, C)
    return qtab_from_hist(hist2, dtype, period=period), hist2


def qtab_from_hist(hist2, dtype, period=None):
    """f32 BH q table from the exact integer histogram (see
    :func:`_chunk_qtab`; the float64 twin is :func:`host_chunk_qtab64`).
    ``period``: for batched tables ([B*S, C], chunk_bh_keep_batched) the
    Poisson right edge of row r is that of LOCAL chunk ``r % period``."""
    S, C = hist2.shape
    m = hist2.sum(axis=1, keepdims=True).astype(dtype)
    # rank_max(s, O): pixels with count >= O  (descending-O cumulative)
    rank_max = jnp.cumsum(hist2[:, ::-1], axis=1)[:, ::-1].astype(dtype)

    ids = jnp.arange(S, dtype=jnp.int32)
    if period is not None:
        ids = ids % period
    rv = jnp.power(2.0, (ids.astype(dtype) - 1.0) / 3.0)[:, None]
    counts = jnp.arange(C, dtype=dtype)[None, :]
    ptab = poisson_sf(counts, rv)

    # empty buckets carry a finite sentinel > 1 (inf would turn the 0*inf
    # products of the selection matmul into NaN); real q-values are <= 1 so
    # the cummin can never wrongly prefer the sentinel
    qraw = jnp.where(rank_max > 0,
                     jnp.minimum(ptab * m / jnp.maximum(rank_max, 1.0), 1.0),
                     2.0)
    return jax.lax.cummin(qraw, axis=1).astype(dtype)


def global_bh_keep(pval, valid, sig):
    """Sort-free device keep SUPERSET for global (bhfdr) BH.

    The Benjamini-Hochberg step-up threshold is the fixed point of
    ``t <- sig * #{p <= t} / m`` started at ``t = sig`` (k is
    nonincreasing along the iteration, so it terminates; at convergence
    ``tau = sig*k*/m`` with ``k* = #{p <= tau}``, the classic sort-free
    BH).  Counts are exact integers (f32-held, < 2^24); only the
    threshold value rounds, so every iteration inflates it by 1e-4
    relative: the inflated iteration dominates the exact-arithmetic one
    pointwise (counts are nondecreasing in t, by induction), hence the
    returned mask is a guaranteed SUPERSET of the exact rejection set
    however f32 rounds.  The controller recomputes exact float64
    q-values for the compacted pixels (:func:`host_bh_complete`) and
    filters — exact, because a pixel outside the superset has every
    suffix term above ``sig`` and so cannot determine a kept pixel's q.

    Returns (keep_superset, m) with m the total valid count.
    """
    infl = jnp.asarray(1.0001, pval.dtype)
    sigf = jnp.asarray(sig, pval.dtype)
    m = jnp.sum(valid).astype(pval.dtype)
    msafe = jnp.maximum(m, 1.0)

    def count(t):
        return jnp.sum(valid & (pval <= t)).astype(pval.dtype)

    def cond(c):
        k, kprev = c
        return k != kprev

    def body(c):
        k, _ = c
        return count(sigf * k / msafe * infl), k

    k, _ = jax.lax.while_loop(cond, body,
                              (count(sigf * infl),
                               jnp.asarray(-1.0, pval.dtype)))
    keep = valid & (pval <= sigf * k / msafe * infl)
    return keep, m


def rank_counts(pval, valid, thresh):
    """Global ranks ``#{valid p <= t}`` for each threshold (exact integer
    counts in f32), as a CH-chunked compare-reduce scan — the same
    no-sort/no-scatter shape as the chunk histogram."""
    pv = pval.ravel()
    vv = valid.ravel()
    n = pv.size
    K = thresh.shape[0]
    CH = max(512, min(32768, ((64 << 20) // max(K, 1)) // 256 * 256))
    pad = -(-n // CH) * CH - n
    pv_p = jnp.pad(pv, (0, pad), constant_values=jnp.inf).reshape(-1, CH)
    vv_p = jnp.pad(vv, (0, pad)).reshape(-1, CH)

    def step(acc, xs):
        p, va = xs
        c = ((p[:, None] <= thresh[None, :]) & va[:, None]
             ).astype(pval.dtype).sum(axis=0)
        return acc + c, None

    ranks, _ = jax.lax.scan(step, jnp.zeros((K,), pval.dtype), (pv_p, vv_p))
    return ranks


def host_bh_complete(p_small, ranks, m, sig):
    """Exact float64 global-BH q-values for the compacted superset
    (p, global rank, m), statsmodels-equivalent: tied p share a rank (the
    max-rank of the tie group) hence a raw value, and the ascending-p
    suffix-min over the superset equals the full suffix-min for every
    pixel whose true q <= sig (see :func:`global_bh_keep`)."""
    import numpy as np
    p = np.asarray(p_small, np.float64)
    r = np.asarray(ranks, np.float64)
    raw = np.minimum(p * float(m) / np.maximum(r, 1.0), 1.0)
    order = np.argsort(p, kind='stable')
    q_sorted = np.minimum.accumulate(raw[order][::-1])[::-1]
    q = np.empty_like(q_sorted)
    q[order] = q_sorted
    return q


def host_chunk_qtab64(hist):
    """Exact float64 (chunk, count) BH q table from the integer histogram.

    The float64 twin of :func:`_chunk_qtab`: within a chunk every pixel's
    p-value depends only on its integer count, so BH over the chunk
    collapses onto the histogram.  The per-count p is evaluated as
    ``1 - poisson.cdf(count; right_edge)`` — the reference's own float64
    expression (callers.py:268-270), replicated VERBATIM rather than the
    numerically superior ``poisson.sf``: at extreme tails ``1 - cdf``
    saturates at ~1e-16 (catastrophic cancellation) where ``sf`` stays
    accurate, and the emitted 3-sig-digit bedpe must match the
    reference's bit-for-bit, artifacts included.  Returns (ptab, qtab),
    both float64 [S, C]."""
    import numpy as np
    from scipy.stats import poisson as _poisson
    hist = np.asarray(hist, np.int64)
    S, C = hist.shape
    m = hist.sum(axis=1, keepdims=True).astype(np.float64)
    rank_max = np.cumsum(hist[:, ::-1], axis=1)[:, ::-1].astype(np.float64)
    rv = np.power(2.0, (np.arange(S, dtype=np.float64) - 1.0) / 3.0)[:, None]
    counts = np.arange(C, dtype=np.float64)[None, :]
    ptab = 1.0 - _poisson.cdf(counts, rv)
    qraw = np.where(rank_max > 0,
                    np.minimum(ptab * m / np.maximum(rank_max, 1.0), 1.0),
                    2.0)
    # BH's suffix-min runs from the largest p backward; within a chunk p is
    # DECREASING in the count, so it is a prefix-min over ascending counts
    # (the float64 twin of _chunk_qtab's lax.cummin)
    qtab = np.minimum.accumulate(qraw, axis=1)
    return ptab, qtab


def host_chunk_complete(O_small, cid_small, hist):
    """Exact float64 p/q for compacted lambda-chunked pixels.

    ``hist`` is the exact int32 (chunk, count) histogram over ALL valid
    pixels (from :func:`chunk_bh_keep`), so the controller reconstructs
    the full per-chunk BH in float64 — identical to running statsmodels'
    fdr_bh on the reference's float64 p-values (callers.py:263-287) given
    the same chunk assignment — and serves the compacted pixels' p/q by
    (chunk, count) lookup.  Returns (p64, q64) float64 arrays."""
    import numpy as np
    ptab, qtab = host_chunk_qtab64(hist)
    S, C = qtab.shape
    oc = np.clip(np.floor(np.asarray(O_small, np.float64)).astype(np.int64),
                 0, C - 1)
    cs = np.clip(np.asarray(cid_small, np.int64), 0, S - 1)
    p, q = ptab[cs, oc], qtab[cs, oc]
    # chunk 0 is the trash row (invalid pixels, compactable only when
    # sig >= 1): they carry p = q = 1 in the reference
    p[cs == 0] = 1.0
    q[cs == 0] = 1.0
    return p, q


def host_chunk_dense(O, cid, valid, sig):
    """Float64 p/q/keep for the DENSE fallback path (keep-cap overflow or
    an explicit host BH request): the exact-histogram completion of
    :func:`host_chunk_complete` computed entirely from fetched dense
    arrays.  Returns (p64, q64, keep) dense arrays (p = q = 1 where
    invalid)."""
    import numpy as np
    O = np.asarray(O)
    c = np.clip(np.asarray(cid), 0, 127).astype(np.int64)
    v = np.asarray(valid)
    oc = np.floor(np.asarray(O, np.float64)).astype(np.int64)
    np.clip(oc, 0, None, out=oc)
    C = int(oc[v].max()) + 1 if v.any() else 1
    oc = np.minimum(oc, C - 1)
    S = 128
    hist = np.bincount((c[v] * C + oc[v]).ravel(),
                       minlength=S * C).reshape(S, C)
    ptab, qtab = host_chunk_qtab64(hist)
    p = np.ones(O.shape, np.float64)
    q = np.ones(O.shape, np.float64)
    p[v] = ptab[c[v], oc[v]]
    q[v] = qtab[c[v], oc[v]]
    return p, q, v & (q <= sig)


def host_bh(pvals, cids, valid):
    """Per-chunk Benjamini-Hochberg on the host (numpy): exact statsmodels
    fdr_bh semantics, no device sort: the host path trades a
    device->host fetch for zero device compile time.  Returns a dense q
    array (1 where invalid)."""
    import numpy as np
    p = np.asarray(pvals, np.float64)
    c = np.asarray(cids)
    v = np.asarray(valid)
    q = np.ones_like(p)
    flat_idx = np.nonzero(v.ravel())[0]
    if flat_idx.size == 0:
        return q
    pv = p.ravel()[flat_idx]
    cv = c.ravel()[flat_idx]
    order = np.lexsort((pv, cv))
    pv_s = pv[order]
    cv_s = cv[order]
    qs = np.empty_like(pv_s)
    boundaries = np.nonzero(np.diff(cv_s))[0] + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [cv_s.size]])
    for s, e in zip(starts, ends):
        m = e - s
        raw = pv_s[s:e] * m / np.arange(1, m + 1)
        qs[s:e] = np.minimum(1.0, np.minimum.accumulate(raw[::-1])[::-1])
    out_sorted = np.empty_like(qs)
    out_sorted[order] = qs
    q.ravel()[flat_idx] = out_sorted
    return q


def gap_vector(cband):
    """Gap bins: zero row-sum of the upper-band balanced matrix
    (callers.py:238/557 uses cM.sum(axis=1) of the diagonal-band matrix)."""
    return jnp.sum(cband, axis=0) == 0


def _shift1(A, k):
    """out[i] = A[i+k], zero outside bounds (k static)."""
    n = A.shape[0]
    if k == 0:
        return A
    if abs(k) >= n:
        return jnp.zeros_like(A)
    if k > 0:
        return jnp.concatenate([A[k:], jnp.zeros(k, A.dtype)])
    return jnp.concatenate([jnp.zeros(-k, A.dtype), A[:k]])


def gap_reject_device(gap, num_p, L, s):
    """Device-side twin of :func:`gap_reject_host`: drop[d, x] = any gap
    bin inside the reference's exclusive-upper windows around x or
    y = x + d (callers.py:291-312).  The windowed counts come from
    STATIC shifts of a cumulative sum plus traced edge masks (no
    gathers), so ``L`` may be a traced scalar — chromosomes of one shape
    bucket then share a single compiled executable (the former static-L
    slicing forced one compile per distinct chromosome length, the real
    cold-start cost of a genome run).  ``s`` stays static (config).

    Host semantics replicated exactly (window [max(pos-s,0),
    min(pos+s, L-1)) — exclusive upper, clamped to L-1 so the last bin
    never counts when the window is cut short at the chromosome end):
    with G[k] = sum g[:k], cnt = G[upper] - G[lower]."""
    Lp = gap.shape[0]
    pos = jnp.arange(Lp)
    g = (gap & (pos < L)).astype(jnp.int32)
    A = jnp.cumsum(g)                       # A[i] = G[i+1]
    total = A[-1]                           # = G[L] (g zero beyond L)
    g_last = jnp.sum(jnp.where(pos == L - 1, g, 0))
    # upper branch pos+s < L: G[pos+s] = A[pos+s-1]; else G[L-1]
    Gu = jnp.where(pos + s < L, _shift1(A, s - 1), total - g_last)
    # lower branch pos > s: G[pos-s] = A[pos-s-1]; else G[0] = 0
    Gl = jnp.where(pos > s, _shift1(A, -(s + 1)), 0)
    cnt = jnp.where(pos < L, Gu - Gl, 0)
    cnt_y = shear_bcast(cnt, num_p)
    return (cnt[None, :] + cnt_y) > 0


def gap_reject_host(gap, num_p, L, s):
    """drop[d, x]: any gap bin inside the reference's (exclusive-upper)
    windows around x or y = x+d (callers.py:291-312).  Computed host-side
    with numpy (one windowed count per bin + a sheared view) and fed to the
    device as a mask input."""
    import numpy as np
    g = np.asarray(gap)[:L].astype(np.int64)
    G = np.concatenate([[0], np.cumsum(g)])
    pos = np.arange(L)
    lower = np.where(pos > s, pos - s, 0)
    upper = np.where(pos + s < L, pos + s, L - 1)
    upper = np.maximum(upper, lower)
    cnt = G[upper] - G[lower]                       # per-bin window count
    Lp = np.asarray(gap).shape[0]
    cnt_full = np.zeros(Lp, np.int64)
    cnt_full[:L] = cnt
    padded = np.concatenate([cnt_full, np.zeros(num_p, np.int64)])
    cnt_y = np.lib.stride_tricks.sliding_window_view(padded, Lp)[:num_p]
    return (cnt_full[None, :] + cnt_y) > 0
