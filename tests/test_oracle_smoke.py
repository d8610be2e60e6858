"""End-to-end smoke tests of the float64 oracle on synthetic data: the
oracle must recover most planted loops, and its incremental background
accumulation must agree with from-scratch region sums."""
import numpy as np
import pytest

from hicpeaks_tpu.io.synth import synthetic_cooler
from hicpeaks_tpu.io.coolerlite import CoolerLite

from .oracle import reference_impl as oracle
from .oracle.prep import prepare_chrom


@pytest.fixture(scope='module')
def synth(tmp_path_factory):
    path = tmp_path_factory.mktemp('data') / 'synth.cool'
    uri, loops = synthetic_cooler(str(path), n_bins=400, res=25000, seed=3,
                                  n_loops=25, depth=60.0)
    return CoolerLite(uri), loops


def _recovered(table, loops, res, tol=3):
    found = 0
    pixels = [(k[0] // res, k[1] // res) for k in table]
    for (x, y) in loops:
        if any(abs(px - x) <= tol and abs(py - y) <= tol for px, py in pixels):
            found += 1
    return found


def test_oracle_bhfdr_recovers_planted_loops(synth):
    clr, loops = synth
    res = clr.binsize
    d = prepare_chrom(clr, '21', maxapart=2000000, maxww=10, ww_min=3)
    table = oracle.bhfdr(d['Md'], d['cMd'], d['B'], d['B'], d['IR'],
                         d['chromLen'], d['num'], pw=1, ww=3, sig=0.05,
                         maxww=10, maxapart=2000000, res=res)
    assert len(table) > 0
    n = _recovered(table, loops, res)
    assert n >= len(loops) * 0.5, f'recovered {n}/{len(loops)}'
    for key, val in table.items():
        assert len(val) == 7          # cen_x, cen_y, radius, O, Fold, p, q
        assert val[4] > 2             # post-clustering fold gate
        assert 0 <= val[6] <= 1


def test_oracle_hiccups_recovers_planted_loops(synth):
    clr, loops = synth
    res = clr.binsize
    d = prepare_chrom(clr, '21', maxapart=2000000, maxww=8, ww_min=3)
    table = oracle.hiccups(d['Md'], d['cMd'], d['B'], d['B'], d['IR'],
                           d['chromLen'], d['num'], pw=[1], ww=[3], sig=0.05,
                           sumq=0.01, maxww=8, maxapart=2000000, res=res,
                           min_marginal_peaks=2, onlyanchor=False,
                           min_local_reads=16)
    assert len(table) > 0
    n = _recovered(table, loops, res)
    assert n >= len(loops) * 0.5, f'recovered {n}/{len(loops)}'
    for key, val in table.items():
        assert len(val) == 10     # cen(2), radius, O, FoldK, pK, qK, FoldY, pY, qY


def _replay_reference_bg(Md, pw, ww, maxww):
    """Literal replay of the reference's incremental branch logic
    (callers.py:143-201) on dense arrays; yields the K/Y/Reads state after
    each pool entry."""
    L = Md.shape[0]
    p_w = oracle._pw_ww_pairs(pw, ww, maxww)
    Mp = oracle._Padded(Md, maxww)
    p_min = min(pw)
    bK = np.zeros((L, L))
    bY = np.zeros((L, L))
    bR = np.zeros((L, L))
    limitCompute = False
    last_pi = last_wi = 0
    for pi, wi in p_w:
        addK, subK, addY, subY, addR = [], [], [], [], []
        for a in range(-wi, wi + 1):
            for b in range(-wi, wi + 1):
                bgloc = max(abs(a), abs(b))
                if limitCompute and (((bgloc <= last_wi) and
                                      (bgloc > max(pi, last_pi))) or
                                     (bgloc <= min(pi, last_pi))):
                    continue
                positive = ((not limitCompute) or (bgloc > last_wi) or
                            (bgloc > pi and bgloc <= last_pi))
                if a != 0 and b != 0 and not oracle._in_P1(a, b, pi) \
                        and not oracle._in_P2(a, b, pi, wi):
                    (addK if positive else subK).append((a, b))
                if oracle._in_P2(a, b, pi, wi):
                    (addK if positive else subK).append((a, b))
                    (addY if positive else subY).append((a, b))
                    if (not limitCompute) or (pi == p_min and bgloc > last_wi):
                        addR.append((a, b))
        oracle._accumulate(bK, Mp, addK, 1.0)
        oracle._accumulate(bK, Mp, subK, -1.0)
        oracle._accumulate(bY, Mp, addY, 1.0)
        oracle._accumulate(bY, Mp, subY, -1.0)
        oracle._accumulate(bR, Mp, addR, 1.0)
        limitCompute = True
        last_pi, last_wi = pi, wi
        yield (pi, wi), bK.copy(), bY.copy(), bR.copy()


def _band_matrix(L, num, seed=0, lam=3.0):
    rng = np.random.default_rng(seed)
    Md = np.zeros((L, L))
    for dd in range(num):
        idx = np.arange(L - dd)
        Md[idx, idx + dd] = rng.poisson(lam, L - dd)
    return Md


def _ring_sums(Md, maxww):
    """ringK_r (all non-cross ring cells) and ringQ_r (lower-left quadrant
    ring cells) for r = 1..maxww, by brute-force cell enumeration."""
    L = Md.shape[0]
    Mp = oracle._Padded(Md, maxww)
    ringK, ringQ = {}, {}
    for r in range(1, maxww + 1):
        cellsK = [(a, b) for a in range(-r, r + 1) for b in range(-r, r + 1)
                  if max(abs(a), abs(b)) == r and a != 0 and b != 0]
        cellsQ = [(a, b) for (a, b) in cellsK if a >= 1 and b <= -1]
        ringK[r] = np.zeros((L, L))
        ringQ[r] = np.zeros((L, L))
        oracle._accumulate(ringK[r], Mp, cellsK, 1.0)
        oracle._accumulate(ringQ[r], Mp, cellsQ, 1.0)
    return ringK, ringQ


def test_single_p_incremental_matches_from_scratch():
    """With a single pw the incremental scheme reconstructs from-scratch
    donut sums exactly (the bhfdr case and single-parameter hiccups)."""
    Md = _band_matrix(60, 30)
    Mp = oracle._Padded(Md, 7)
    for (pi, wi), bK, _, _ in _replay_reference_bg(Md, [2], [5], 7):
        direct = np.zeros_like(Md)
        cells = [(a, b) for a in range(-wi, wi + 1) for b in range(-wi, wi + 1)
                 if a != 0 and b != 0 and not oracle._in_P1(a, b, pi)]
        oracle._accumulate(direct, Mp, cells, 1.0)
        np.testing.assert_allclose(bK, direct, atol=1e-9,
                                   err_msg=f'(p,w)=({pi},{wi})')


def test_multi_p_drift_matches_ring_model():
    """With multiple pw values the reference accumulation drifts (rings
    re-added on p decreases, never subtracted on p increases).  The pool
    plan's ring-multiplicity model must predict the exact state after every
    entry — this is the contract the device scan is built on."""
    from hicpeaks_tpu.core.poolplan import hiccups_pool_plan

    pw, ww, maxww = [1, 2, 4], [3, 5, 7], 9
    Md = _band_matrix(64, 32, seed=1)
    ringK, ringQ = _ring_sums(Md, maxww)
    plan = hiccups_pool_plan(pw, ww, maxww)

    multK = np.zeros(maxww + 1)
    replay = _replay_reference_bg(Md, pw, ww, maxww)
    readsK = np.zeros_like(Md)
    for entry, ((pi, wi), bK, bY, bR) in zip(plan, replay):
        assert (entry.p, entry.w) == (pi, wi)
        for r in entry.bg_rings:
            multK[r] += 1
        predK = sum(multK[r] * ringK[r] for r in range(1, maxww + 1))
        predY = sum(multK[r] * ringQ[r] for r in range(1, maxww + 1))
        for r in entry.reads_rings:
            readsK += ringQ[r]
        np.testing.assert_allclose(bK, predK, atol=1e-9,
                                   err_msg=f'K at (p,w)=({pi},{wi})')
        np.testing.assert_allclose(bY, predY, atol=1e-9,
                                   err_msg=f'Y at (p,w)=({pi},{wi})')
        np.testing.assert_allclose(bR, readsK, atol=1e-9,
                                   err_msg=f'Reads at (p,w)=({pi},{wi})')
