"""BH implementations: device segmented_bh (two-level scans, ordinal
offsets) and host_bh, both against the statsmodels-equivalent oracle."""
import jax.numpy as jnp
import numpy as np
import pytest

from hicpeaks_tpu.ops.score import segmented_bh, host_bh

from .oracle.multitest import fdr_bh


def _reference_segmented(p, seg, valid):
    q = np.ones_like(p)
    for s in np.unique(seg[valid]):
        m = valid & (seg == s)
        q[m] = fdr_bh(p[m])[1]
    return q


@pytest.mark.parametrize('n,nseg,seed', [(257, 1, 0), (5000, 7, 1),
                                         (20000, 40, 2), (100000, 60, 3)])
def test_segmented_bh_matches_reference(n, nseg, seed):
    rng = np.random.default_rng(seed)
    p = rng.random(n) ** 3
    seg = rng.integers(1, nseg + 1, n)
    valid = rng.random(n) < 0.8
    want = _reference_segmented(p, seg, valid)

    got = np.asarray(segmented_bh(jnp.asarray(p), jnp.asarray(seg),
                                  jnp.asarray(valid)))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)

    got_host = host_bh(p, seg, valid)
    np.testing.assert_allclose(got_host, want, rtol=1e-12)


def test_segmented_bh_ties_and_empty():
    p = np.array([0.5, 0.5, 0.5, 0.1, 0.1, 1.0])
    seg = np.array([1, 1, 1, 2, 2, 2])
    valid = np.ones(6, bool)
    want = _reference_segmented(p, seg, valid)
    got = np.asarray(segmented_bh(jnp.asarray(p), jnp.asarray(seg),
                                  jnp.asarray(valid)))
    np.testing.assert_allclose(got, want, rtol=1e-12)

    # all-invalid input
    got = np.asarray(segmented_bh(jnp.asarray(p), jnp.asarray(seg),
                                  jnp.zeros(6, bool)))
    np.testing.assert_array_equal(got, np.ones(6))
    np.testing.assert_array_equal(host_bh(p, seg, np.zeros(6, bool)),
                                  np.ones(6))


def test_two_level_scan_crosses_row_boundaries():
    """Force the two-level path (> _SCAN_ROW elements) with segments that
    straddle row boundaries."""
    from hicpeaks_tpu.ops import score as so
    n = so._SCAN_ROW * 3 + 17
    rng = np.random.default_rng(5)
    p = rng.random(n)
    seg = np.sort(rng.integers(1, 5, n))   # long runs crossing rows
    valid = np.ones(n, bool)
    want = _reference_segmented(p, seg, valid)
    got = np.asarray(segmented_bh(jnp.asarray(p), jnp.asarray(seg),
                                  jnp.asarray(valid)))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_segmented_bh_tiny_p_float32_many_segments():
    """ADVICE r1: the former ordinal-offset suffix-min clamped q-values
    below ~ulp(2*n_segments) (~1e-5 in f32 at ~100 segments).  The exact
    pair-scan must preserve tiny q-values even in float32."""
    rng = np.random.default_rng(11)
    n, nseg = 50000, 120
    p = rng.random(n).astype(np.float32)
    seg = rng.integers(1, nseg + 1, n)
    valid = np.ones(n, bool)
    # plant astronomically small p-values across many segments
    tiny_idx = rng.choice(n, 200, replace=False)
    p[tiny_idx] = 10.0 ** rng.uniform(-30, -8, 200)

    got = np.asarray(segmented_bh(jnp.asarray(p, jnp.float32),
                                  jnp.asarray(seg), jnp.asarray(valid)))
    want = _reference_segmented(p.astype(np.float64), seg, valid)
    # f32 rounding only in p*m/rank — never in the suffix-min itself
    np.testing.assert_allclose(got[tiny_idx], want[tiny_idx], rtol=1e-5)
    # q = p*m/rank with p <= 1e-8 and m <= n: far below the old ~1e-5 clamp
    assert (got[tiny_idx] < 1e-3).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_chunk_histogram_bh_matches_sort_bh():
    """The sort-free lambda-chunk histogram BH must equal the sorted BH
    whenever p = sf(floor(O); rv[cid]) (the hiccups chunked path)."""
    from hicpeaks_tpu.ops.score import chunk_bh_histogram, poisson_sf

    rng = np.random.default_rng(7)
    n = 40000
    O = rng.poisson(8.0, n).astype(np.float64)
    cid = rng.integers(1, 30, n).astype(np.int32)
    valid = rng.random(n) < 0.85
    rv = np.power(2.0, (cid - 1) / 3.0)
    pval = np.asarray(poisson_sf(jnp.asarray(O), jnp.asarray(rv)))
    pval = np.where(valid, pval, 1.0)

    q_sort = np.asarray(segmented_bh(jnp.asarray(pval), jnp.asarray(cid),
                                     jnp.asarray(valid)))
    q_hist = np.asarray(chunk_bh_histogram(jnp.asarray(O), jnp.asarray(cid),
                                           jnp.asarray(valid), o_cap=256))
    np.testing.assert_allclose(q_hist, q_sort, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize('sig', [0.05, 0.31, 1.0])
def test_chunk_bh_keep_matches_dense_threshold(sig):
    """chunk_bh_keep's per-chunk count threshold must reproduce
    (chunk_bh_histogram <= sig) exactly (q is a cummin over ascending
    counts, so the collapse is a theorem, not an approximation), and its
    qtab must serve the exact per-pixel q for the compacted lookup."""
    from hicpeaks_tpu.ops.score import chunk_bh_histogram, chunk_bh_keep

    from hicpeaks_tpu.ops.score import lambda_chunks

    rng = np.random.default_rng(13)
    n = 30000
    O = rng.poisson(6.0, n).astype(np.float32)
    # E spanning many chunks, including exact chunk-edge values (invalid)
    # and a few enormous values that clip at the n_chunks cap
    E = np.exp(rng.uniform(np.log(0.05), np.log(300.0), n)).astype(np.float32)
    E[::97] = np.power(2.0, (rng.integers(0, 20, len(E[::97])) - 1) / 3.0
                       ).astype(np.float32)
    E[::401] = np.float32(1e13)
    scored = rng.random(n) < 0.9
    cid, rv, valid = (np.asarray(a) for a in lambda_chunks(
        jnp.asarray(E), jnp.asarray(scored)))

    q_dense = np.asarray(chunk_bh_histogram(
        jnp.asarray(O), jnp.asarray(cid), jnp.asarray(valid), o_cap=256))
    keep, qtab, hist, _thr, _ok = chunk_bh_keep(jnp.asarray(O),
                                     jnp.asarray(cid), jnp.asarray(valid),
                                     jnp.float32(sig), o_cap=256)
    np.testing.assert_array_equal(np.asarray(keep), q_dense <= sig)

    oc = np.clip(np.floor(O).astype(np.int64), 0, 256)
    qt = np.asarray(qtab)
    q_lookup = np.where(valid, qt[np.clip(cid, 0, 127), oc], 1.0)
    np.testing.assert_array_equal(q_lookup, q_dense)

    # the returned integer histogram is exact on every real chunk row
    # (row 0 is the trash row: invalid pixels plus scan padding)
    want_hist = np.zeros((128, 257), np.int64)
    np.add.at(want_hist, (np.where(valid, np.clip(cid, 1, 127), 0), oc), 1)
    np.testing.assert_array_equal(np.asarray(hist)[1:], want_hist[1:])


@pytest.mark.parametrize('sig', [0.05, 0.1])
def test_host_chunk_complete_matches_f64_reference(sig):
    """The controller's float64 completion (superset keep -> histogram ->
    host_chunk_complete -> filter) must reproduce the statsmodels-
    equivalent per-chunk BH on float64 p-values EXACTLY — the reference's
    emitted statistics (callers.py:263-287), with zero f32 residue."""
    from scipy.stats import poisson as sp_poisson

    from hicpeaks_tpu.ops.score import (chunk_bh_keep, host_chunk_complete,
                                        host_chunk_dense, lambda_chunks)

    rng = np.random.default_rng(31)
    n = 50000
    O = rng.poisson(6.0, n).astype(np.float32)
    O[:64] = rng.integers(40, 220, 64)     # extreme-tail p-values
    E = np.exp(rng.uniform(np.log(0.05), np.log(300.0), n)).astype(np.float32)
    scored = rng.random(n) < 0.9
    cid, rv, valid = (np.asarray(a) for a in lambda_chunks(
        jnp.asarray(E), jnp.asarray(scored)))

    # f64 reference: per-chunk statsmodels BH on the reference's own
    # p expression 1 - cdf (callers.py:268-270; NOT sf — at extreme
    # tails they differ and the emitted file must match the reference)
    rv64 = np.power(2.0, (cid.astype(np.float64) - 1.0) / 3.0)
    p64_ref = np.ones(n)
    p64_ref[valid] = 1.0 - sp_poisson.cdf(
        np.floor(O[valid].astype(np.float64)), rv64[valid])
    q64_ref = np.ones(n)
    for c in np.unique(cid[valid]):
        sel = valid & (cid == c)
        q64_ref[sel] = fdr_bh(p64_ref[sel], alpha=sig)[1]
    ref_keep = valid & (q64_ref <= sig)

    keep, _qtab, hist, _thr, _ok = chunk_bh_keep(
        jnp.asarray(O), jnp.asarray(cid), jnp.asarray(valid),
        jnp.float32(sig), o_cap=256, slack=0.01)
    keep = np.asarray(keep)
    assert (keep | ~ref_keep).all(), 'inflated keep must be a superset'

    idx = np.nonzero(keep)[0]
    p64, q64 = host_chunk_complete(O[idx], cid[idx], hist)
    fin = q64 <= sig
    got_keep = np.zeros(n, bool)
    got_keep[idx[fin]] = True
    np.testing.assert_array_equal(got_keep, ref_keep)
    np.testing.assert_allclose(p64[fin], p64_ref[idx[fin]], rtol=0, atol=0)
    np.testing.assert_allclose(q64[fin], q64_ref[idx[fin]], rtol=0, atol=0)

    # the dense fallback completion agrees bit-for-bit
    pd, qd, keepd = host_chunk_dense(O, cid, valid, sig)
    np.testing.assert_array_equal(keepd, ref_keep)
    np.testing.assert_allclose(pd[valid], p64_ref[valid], rtol=0, atol=0)
    np.testing.assert_allclose(qd[valid], q64_ref[valid], rtol=0, atol=0)


@pytest.mark.parametrize('seed,sig', [(0, 0.05), (1, 0.1), (2, 0.31)])
def test_fixpoint_global_bh_matches_reference(seed, sig):
    """global_bh_keep's fixpoint superset + host_bh_complete's f64 ranks
    reproduce statsmodels-equivalent global BH exactly, including heavy
    ties sitting on the rejection boundary."""
    from hicpeaks_tpu.ops.score import (global_bh_keep, host_bh_complete,
                                        rank_counts)

    rng = np.random.default_rng(seed)
    n = 60000
    p = rng.random(n).astype(np.float32)
    # plant significant blocks + exact ties (tie groups share a rank)
    p[:300] = (10.0 ** rng.uniform(-9, -3, 300)).astype(np.float32)
    p[300:380] = p[300]                      # 80-way tie, significant
    p[380:420] = np.float32(sig * 0.9)       # tie near the boundary
    valid = rng.random(n) < 0.9

    want_rej, want_q = fdr_bh(np.where(valid, p, 1.0)[valid].astype(
        np.float64), alpha=sig)

    keep, m = global_bh_keep(jnp.asarray(p), jnp.asarray(valid),
                             jnp.float32(sig))
    keep = np.asarray(keep)
    assert int(m) == valid.sum()
    # superset of the exact rejection set
    exact_keep = np.zeros(n, bool)
    exact_keep[valid] = want_rej
    assert (keep | ~exact_keep).all()

    idx = np.nonzero(keep)[0]
    ranks = np.asarray(rank_counts(jnp.asarray(p), jnp.asarray(valid),
                                   jnp.asarray(p[idx])))
    q = host_bh_complete(p[idx], ranks, float(m), sig)
    fin = q <= sig
    # the filtered set equals the exact rejection set ...
    got_keep = np.zeros(n, bool)
    got_keep[idx[fin]] = True
    np.testing.assert_array_equal(got_keep, exact_keep)
    # ... and q-values match the f64 reference exactly on it
    qmap = np.full(n, np.nan)
    qmap[valid] = want_q
    np.testing.assert_allclose(q[fin], qmap[idx[fin]], rtol=0, atol=0)


@pytest.mark.parametrize('shape,cap,density,seed', [
    ((7, 130), 16, 0.3, 0),        # n not a multiple of the block width
    ((64, 512), 64, 0.001, 1),     # sparse, count < cap
    ((64, 512), 64, 0.5, 2),       # overflow: count >> cap
    ((3, 41), 8, 0.0, 3),          # empty mask
    ((200, 600), 1 << 15, 0.01, 4),  # large-cap tier (block = 128)
])
def test_compact_mask_matches_nonzero(shape, cap, density, seed):
    """compact_mask's hierarchical block search must return exactly the
    first ``cap`` row-major True positions (np.nonzero order), the true
    count, and last-cell padding past the count / on overflow."""
    from hicpeaks_tpu.ops.score import compact_mask

    rng = np.random.default_rng(seed)
    keep = rng.random(shape) < density
    cnt, d_idx, x_idx = (np.asarray(a) for a in
                         compact_mask(jnp.asarray(keep), cap))
    R, C = shape
    rr, cc = np.nonzero(keep)
    assert int(cnt) == len(rr)
    k = min(len(rr), cap)
    np.testing.assert_array_equal(d_idx[:k], rr[:k])
    np.testing.assert_array_equal(x_idx[:k], cc[:k])
    # past-count entries point at the last cell
    np.testing.assert_array_equal(d_idx[k:], np.full(cap - k, R - 1))
    np.testing.assert_array_equal(x_idx[k:], np.full(cap - k, C - 1))


@pytest.mark.parametrize('B,sig,seed', [(2, 0.05, 0), (4, 0.05, 1),
                                        (4, 0.2, 2)])
def test_chunk_bh_keep_batched_matches_per_background(B, sig, seed):
    """The batched histogram-keep (one body for all backgrounds,
    engine._compact_batched's core) must be BIT-IDENTICAL to running
    chunk_bh_keep per background: same keep mask, same integer
    histogram block, same per-chunk thresholds, and a q-table whose
    rows wrap the Poisson right edge modulo 128."""
    from hicpeaks_tpu.ops.score import chunk_bh_keep, chunk_bh_keep_batched

    rng = np.random.default_rng(seed)
    shape = (B, 24, 256)
    O = np.floor(rng.gamma(1.5, 8.0, shape)).astype(np.float64)
    # per-background expected values -> independent chunk ids
    E = rng.gamma(2.0, 3.0, shape) + 1e-3
    cid = np.clip(np.floor(3 * np.log2(E)).astype(np.int32) + 2, 1, 127)
    valid = rng.random(shape) < 0.8
    o_cap = 256

    keep_b, qtab_b, hist_b, thr_b, _okb = chunk_bh_keep_batched(
        jnp.asarray(O), jnp.asarray(cid), jnp.asarray(valid), sig, B,
        o_cap=o_cap, slack=0.01)
    for b in range(B):
        keep1, qtab1, hist1, thr1, _ok1 = chunk_bh_keep(
            jnp.asarray(O[b]), jnp.asarray(cid[b]), jnp.asarray(valid[b]),
            sig, o_cap=o_cap, slack=0.01)
        np.testing.assert_array_equal(np.asarray(keep_b)[b],
                                      np.asarray(keep1), err_msg=f'b={b}')
        np.testing.assert_array_equal(
            np.asarray(hist_b).reshape(B, 128, -1)[b], np.asarray(hist1))
        np.testing.assert_array_equal(np.asarray(thr_b)[b],
                                      np.asarray(thr1))
        np.testing.assert_array_equal(
            np.asarray(qtab_b).reshape(B, 128, -1)[b], np.asarray(qtab1))


def test_split_histogram_matches_unsplit():
    """chunk_bh_keep's split histogram (hcap set, C-1 > 2*_HIST_T) must be
    bit-identical to the one-pass histogram — including the row-0 trash
    cells — and must flag overflow when the high-count tail exceeds hcap."""
    import numpy as np
    import jax.numpy as jnp
    from hicpeaks_tpu.ops.score import chunk_bh_keep, chunk_bh_keep_batched

    rng = np.random.default_rng(7)
    num_p, Lp = 41, 640
    S, o_cap = 40, 2048
    O = np.where(rng.random((num_p, Lp)) < 0.03,
                 rng.integers(500, 2000, (num_p, Lp)),
                 rng.integers(0, 80, (num_p, Lp))).astype(np.float32)
    cid = rng.integers(1, 45, (num_p, Lp)).astype(np.int32)
    valid = rng.random((num_p, Lp)) < 0.6
    sig = 0.05

    base = chunk_bh_keep(jnp.asarray(O), jnp.asarray(cid),
                         jnp.asarray(valid), sig, n_chunks=S, o_cap=o_cap,
                         slack=0.01)
    split = chunk_bh_keep(jnp.asarray(O), jnp.asarray(cid),
                          jnp.asarray(valid), sig, n_chunks=S, o_cap=o_cap,
                          slack=0.01, hcap=4096)
    assert bool(split[4])
    np.testing.assert_array_equal(np.asarray(base[2]), np.asarray(split[2]))
    np.testing.assert_array_equal(np.asarray(base[0]), np.asarray(split[0]))
    np.testing.assert_array_equal(np.asarray(base[3]), np.asarray(split[3]))

    overflow = chunk_bh_keep(jnp.asarray(O), jnp.asarray(cid),
                             jnp.asarray(valid), sig, n_chunks=S,
                             o_cap=o_cap, slack=0.01, hcap=16)
    assert not bool(overflow[4])

    B = 3
    cidb = jnp.asarray(np.stack([cid, cid + 1, np.maximum(cid - 1, 1)]))
    validb = jnp.asarray(np.stack([valid, ~valid, valid]))
    Ob = jnp.broadcast_to(jnp.asarray(O), (B, num_p, Lp))
    b0 = chunk_bh_keep_batched(Ob, cidb, validb, sig, B, n_chunks=S,
                               o_cap=o_cap, slack=0.01)
    b1 = chunk_bh_keep_batched(Ob, cidb, validb, sig, B, n_chunks=S,
                               o_cap=o_cap, slack=0.01, hcap=4096)
    np.testing.assert_array_equal(np.asarray(b0[2]), np.asarray(b1[2]))
    np.testing.assert_array_equal(np.asarray(b0[0]), np.asarray(b1[0]))


@pytest.mark.parametrize('n,o_cap,seed', [(5000, 256, 0), (70000, 512, 1),
                                          (300, 131, 2)])
def test_chunk_hist_matches_bincount(n, o_cap, seed):
    """The (chunk, count) histogram of the packed streams equals
    np.bincount over the combined key exactly: counts clipped at the cap,
    invalid pixels folded into trash row 0, and the pack's zero padding
    in the (0, 0) trash cell."""
    from hicpeaks_tpu.ops.score import _chunk_pack, chunk_hist

    rng = np.random.default_rng(seed)
    S, C = 128, o_cap + 1
    O = rng.poisson(9.0, n).astype(np.float32)
    O[rng.random(n) < 0.01] = o_cap * 3.0          # clip-at-cap bucket
    cid = rng.integers(1, S, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    Oc_p, cid_p, _ = _chunk_pack(jnp.asarray(O), jnp.asarray(cid),
                                 jnp.asarray(valid), S, C)
    got = np.asarray(chunk_hist(Oc_p, cid_p, S, C))
    key = (np.asarray(cid_p, np.int64) * C
           + np.asarray(Oc_p, np.int64)).ravel()
    want = np.bincount(key, minlength=S * C).reshape(S, C)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == Oc_p.size and got[0, 0] >= Oc_p.size - n


@pytest.mark.parametrize('sig', [0.05, 0.31])
def test_chunk_bh_keep_matches_sort_bh(sig):
    """chunk_bh_keep's histogram keep mask equals the sort-based rule:
    segmented_bh over p = sf(floor(O); right edge of the pixel's lambda
    chunk), kept where q <= sig."""
    from hicpeaks_tpu.ops.score import (chunk_bh_keep, lambda_chunks,
                                        poisson_sf)

    rng = np.random.default_rng(23)
    n = 40000
    O = rng.poisson(6.0, n).astype(np.float64)
    E = np.exp(rng.uniform(np.log(0.05), np.log(300.0), n))
    scored = rng.random(n) < 0.9
    cid, rv, valid = lambda_chunks(jnp.asarray(E), jnp.asarray(scored))
    pval = jnp.where(valid, poisson_sf(jnp.asarray(O), rv), 1.0)
    q_sort = np.asarray(segmented_bh(pval, cid, valid))
    keep, _, _, _, _ = chunk_bh_keep(jnp.asarray(O), cid, valid, sig,
                                     o_cap=256)
    want = np.asarray(valid) & (q_sort <= sig)
    assert want.sum() > 0
    np.testing.assert_array_equal(np.asarray(keep), want)
