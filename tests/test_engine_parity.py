"""End-to-end parity: the device engine must reproduce the float64 oracle's
peak tables on synthetic data — identical loci, cluster geometry, and
statistics to floating-point tolerance (SURVEY §7 'bit-exactness vs
performance': loci exact, q-values tolerance-compared)."""
import numpy as np
import pytest

from hicpeaks_tpu.io.synth import synthetic_cooler
from hicpeaks_tpu.io.coolerlite import CoolerLite
from hicpeaks_tpu.core.config import BHFDRConfig, HiccupsConfig
from hicpeaks_tpu.core import engine
from hicpeaks_tpu.ops.band import bands_from_cooler

from .oracle import reference_impl as oracle
from .oracle.prep import prepare_chrom


@pytest.fixture(scope='module')
def synth(tmp_path_factory):
    path = tmp_path_factory.mktemp('data') / 'parity.cool'
    uri, loops = synthetic_cooler(str(path), n_bins=420, res=25000, seed=11,
                                  n_loops=30, depth=60.0)
    return CoolerLite(uri), loops


def _assert_tables_match(got, want, stat_slice, rtol=1e-8, atol=1e-300):
    # The engine completes every emitted statistic in float64 on the host
    # (exact ring-sum replay + suspect-corrected chunk histograms,
    # ops/hostexact.py), so the only slack vs the float64 oracle is f64
    # summation ORDER in the ring sums (~1e-13 relative on E) amplified by
    # the Poisson tail sensitivity d log p / d log E ~ (O - E).  Round 2
    # needed rtol 2e-4 here (f32 chunk-membership shifted per-chunk m by
    # one); round 3's suspect correction closes that.
    assert set(got) == set(want), (
        f'locus sets differ: extra={sorted(set(got) - set(want))[:5]} '
        f'missing={sorted(set(want) - set(got))[:5]}')
    for key in want:
        g, w = got[key], want[key]
        # centroid/radius are integers (bins*res)
        assert tuple(g[:3]) == tuple(w[:3]), f'{key}: geometry {g[:3]} != {w[:3]}'
        np.testing.assert_allclose(np.asarray(g[3:], float),
                                   np.asarray(w[3:], float),
                                   rtol=rtol, atol=atol, err_msg=str(key))


def test_bhfdr_engine_matches_oracle(synth):
    clr, _ = synth
    res = clr.binsize
    cfg = BHFDRConfig(pw=1, ww=3, maxww=10, siglevel=0.05, maxapart=2000000)
    d = prepare_chrom(clr, '21', cfg.maxapart, cfg.maxww, cfg.ww)
    want = oracle.bhfdr(d['Md'], d['cMd'], d['B'], d['B'], d['IR'],
                        d['chromLen'], d['num'], pw=cfg.pw, ww=cfg.ww,
                        sig=cfg.siglevel, maxww=cfg.maxww,
                        maxapart=cfg.maxapart, res=res)
    bands = bands_from_cooler(clr, '21', cfg.maxapart, cfg.maxww, cfg.ww,
                              dtype=np.float64)
    got = engine.bhfdr_chrom(bands, cfg)
    assert len(want) > 0
    _assert_tables_match(got, want, slice(3, None))


@pytest.mark.parametrize('pw,ww,maxww', [
    ((1,), (3,), 8),
    ((1, 2), (3, 5), 8),    # multi-p: exercises the drift re-adds
])
def test_hiccups_engine_matches_oracle(synth, pw, ww, maxww):
    clr, _ = synth
    res = clr.binsize
    cfg = HiccupsConfig(pw=pw, ww=ww, maxww=maxww, siglevel=0.05, sumq=0.01,
                        maxapart=2000000, min_marginal_peaks=2,
                        min_local_reads=16, only_anchors=False)
    d = prepare_chrom(clr, '21', cfg.maxapart, cfg.maxww, min(ww))
    want = oracle.hiccups(d['Md'], d['cMd'], d['B'], d['B'], d['IR'],
                          d['chromLen'], d['num'], pw=list(pw), ww=list(ww),
                          maxww=maxww, sig=cfg.siglevel, sumq=cfg.sumq,
                          double_fold=cfg.double_fold,
                          single_fold=cfg.single_fold,
                          maxapart=cfg.maxapart, res=res,
                          min_marginal_peaks=2, onlyanchor=False,
                          min_local_reads=16)
    bands = bands_from_cooler(clr, '21', cfg.maxapart, cfg.maxww, min(ww),
                              dtype=np.float64)
    got = engine.hiccups_chrom(bands, cfg)
    assert len(want) > 0
    _assert_tables_match(got, want, slice(3, None))


def test_shape_bucketing_invariant(synth):
    """Padding the band width to a shared bucket (api's compile-sharing
    trick) must not change results."""
    clr, _ = synth
    cfg = BHFDRConfig(pw=1, ww=3, maxww=8, maxapart=2000000)
    a = engine.bhfdr_chrom(bands_from_cooler(
        clr, '21', cfg.maxapart, cfg.maxww, cfg.ww, dtype=np.float64), cfg)
    b = engine.bhfdr_chrom(bands_from_cooler(
        clr, '21', cfg.maxapart, cfg.maxww, cfg.ww, dtype=np.float64,
        lane_pad=4096), cfg)
    assert a == b


def test_bhfdr_parity_shallow_data_truncation(tmp_path_factory):
    """Shallow coverage forces the freeze early-stops (Valid_Ratio < 0.3
    break, callers.py:505-511) — the truncation replay must match the
    oracle exactly."""
    path = tmp_path_factory.mktemp('data') / 'shallow.cool'
    uri, _ = synthetic_cooler(str(path), n_bins=380, res=25000, seed=17,
                              n_loops=15, depth=12.0)
    clr = CoolerLite(uri)
    cfg = BHFDRConfig(pw=1, ww=3, maxww=10, maxapart=2000000)
    d = prepare_chrom(clr, '21', cfg.maxapart, cfg.maxww, cfg.ww)
    want = oracle.bhfdr(d['Md'], d['cMd'], d['B'], d['B'], d['IR'],
                        d['chromLen'], d['num'], pw=cfg.pw, ww=cfg.ww,
                        sig=cfg.siglevel, maxww=cfg.maxww,
                        maxapart=cfg.maxapart, res=clr.binsize)
    bands = bands_from_cooler(clr, '21', cfg.maxapart, cfg.maxww, cfg.ww,
                              dtype=np.float64)
    got = engine.bhfdr_chrom(bands, cfg)
    _assert_tables_match(got, want, slice(3, None))


def test_hiccups_parity_shallow_data_frozen_w(tmp_path_factory):
    """Shallow coverage with w >= max(ww) triggers the hiccups frozen_w
    assignment (callers.py:223-229); multi-p truncation must match."""
    path = tmp_path_factory.mktemp('data') / 'shallow2.cool'
    uri, _ = synthetic_cooler(str(path), n_bins=380, res=25000, seed=19,
                              n_loops=15, depth=15.0)
    clr = CoolerLite(uri)
    cfg = HiccupsConfig(pw=(1, 2), ww=(3, 5), maxww=9, maxapart=2000000,
                        min_marginal_peaks=2, min_local_reads=16)
    d = prepare_chrom(clr, '21', cfg.maxapart, cfg.maxww, 3)
    want = oracle.hiccups(d['Md'], d['cMd'], d['B'], d['B'], d['IR'],
                          d['chromLen'], d['num'], pw=[1, 2], ww=[3, 5],
                          maxww=9, sig=cfg.siglevel, sumq=cfg.sumq,
                          double_fold=cfg.double_fold,
                          single_fold=cfg.single_fold,
                          maxapart=cfg.maxapart, res=clr.binsize,
                          min_marginal_peaks=2, onlyanchor=False,
                          min_local_reads=16)
    bands = bands_from_cooler(clr, '21', cfg.maxapart, cfg.maxww, 3,
                              dtype=np.float64)
    got = engine.hiccups_chrom(bands, cfg)
    _assert_tables_match(got, want, slice(3, None))


def test_hiccups_engine_float32_bands_matches_oracle(tmp_path):
    """Production dtype: float32 bands through the fused one-program
    path, statistics completed in float64 on the host, match the float64
    oracle on a synthetic chromosome (identical loci and geometry,
    statistics to 1e-8)."""
    uri, _ = synthetic_cooler(str(tmp_path / 'f32.cool'), n_bins=256,
                              res=25000, seed=13, n_loops=15, depth=60.0)
    clr = CoolerLite(uri)
    cfg = HiccupsConfig(pw=(1,), ww=(3,), maxww=6, maxapart=1500000,
                        min_marginal_peaks=2, min_local_reads=16)
    d = prepare_chrom(clr, '21', cfg.maxapart, cfg.maxww, 3)
    want = oracle.hiccups(d['Md'], d['cMd'], d['B'], d['B'], d['IR'],
                          d['chromLen'], d['num'], pw=[1], ww=[3], maxww=6,
                          sig=cfg.siglevel, sumq=cfg.sumq,
                          double_fold=cfg.double_fold,
                          single_fold=cfg.single_fold,
                          maxapart=cfg.maxapart, res=clr.binsize,
                          min_marginal_peaks=2, onlyanchor=False,
                          min_local_reads=16)
    bands = bands_from_cooler(clr, '21', cfg.maxapart, cfg.maxww, 3,
                              dtype=np.float32)
    got = engine.hiccups_chrom(bands, cfg)
    assert len(want) > 0
    _assert_tables_match(got, want, slice(3, None))
