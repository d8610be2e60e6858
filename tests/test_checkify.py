"""Opt-in checkify instrumentation of the scoring step (SURVEY §5
'race detection / sanitizers' row): clean data passes with identical
results; corrupted data raises instead of silently propagating NaN."""
import numpy as np
import pytest

from hicpeaks_tpu.core import engine, flagship
from hicpeaks_tpu.core.config import BHFDRConfig, HiccupsConfig


def _bands():
    return flagship.demo_inputs(L=256, num=64, dtype='float32')


def test_checkify_clean_run_matches_unchecked():
    bands = _bands()
    cfg = HiccupsConfig(pw=(1, 2), ww=(3, 5), maxww=8,
                        maxapart=40 * bands.res, min_marginal_peaks=2,
                        min_local_reads=16)
    plain = engine.hiccups_chrom(bands, cfg)
    checked = engine.hiccups_chrom(bands, cfg, check=True)
    assert checked == plain

    bcfg = BHFDRConfig(pw=1, ww=3, maxww=8, maxapart=40 * bands.res,
                       min_marginal_peaks=2)
    assert engine.bhfdr_chrom(bands, bcfg, check=True) == \
        engine.bhfdr_chrom(bands, bcfg)


def test_checkify_catches_nan_corruption():
    bands = _bands()
    # corrupt one in-band raw pixel with NaN: it passes the `!= 0`
    # candidate test and reaches the Poisson stage, where float_checks
    # must fire instead of the NaN silently washing through BH
    d, x = 10, 50
    bands.raw[d, x] = np.nan
    cfg = BHFDRConfig(pw=1, ww=3, maxww=8, maxapart=40 * bands.res,
                      min_marginal_peaks=2)
    with pytest.raises(Exception, match='(?i)nan|check'):
        engine.bhfdr_chrom(bands, cfg, check=True)


def test_checkify_scan_math_clean_and_poisoned():
    """checkify sweep of the ring-scan math (ops/scan._scan, the body of
    both passes): float/index instrumentation on clean data leaves the
    captures unchanged, and a NaN produced inside the scan is flagged.
    Out-of-bounds behaviour on ragged shapes is pinned separately by
    test_scan's NumPy-model sweep."""
    import jax.numpy as jnp
    from jax.experimental import checkify

    from hicpeaks_tpu.core import poolplan
    from hicpeaks_tpu.ops import scan as scan_ops

    bands = _bands()
    raw = jnp.asarray(bands.raw)
    cband = raw * 0.7
    eband = jnp.ones_like(raw)
    cand = raw != 0
    plan = tuple(poolplan.hiccups_pool_plan([1], [3], 6))
    allowed = jnp.ones(len(plan), bool)

    def run(raw, cband, eband, cand):
        return scan_ops._scan(raw, cband, eband, cand, plan, (1,), 16,
                              allowed, True)

    checked = checkify.checkify(
        run, errors=checkify.float_checks | checkify.index_checks)
    err, (counts, _, outs) = checked(raw, cband, eband, cand)
    err.throw()   # clean data: no error
    _, _, want = scan_ops.scan_pass_b(raw, cband, eband, cand, allowed,
                                      plan, (1,), 16)
    for t in range(4):
        np.testing.assert_array_equal(np.asarray(outs[1][t]),
                                      np.asarray(want[1][t]))

    # NaN poison: checkify's float checks flag any op that *produces* a
    # NaN (an already-inf input that merely propagates does not trip them)
    bad = raw.at[5, 60].set(jnp.nan)
    err, _ = checked(bad, bad * 0.7, eband, cand.at[5, 60].set(True))
    with pytest.raises(Exception, match='(?i)nan|inf|check'):
        err.throw()
