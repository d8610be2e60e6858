"""The jnp ring scan must reproduce the reference's background accumulator
states (validated via the literal branch replay from the oracle tests) in
band-tensor space, for both the single-p and the drifting multi-p pools."""
import numpy as np
import jax.numpy as jnp
import pytest

from hicpeaks_tpu.core import poolplan
from hicpeaks_tpu.ops import scan as scan_ops

from .oracle import reference_impl as oracle
from .test_oracle_smoke import _band_matrix, _replay_reference_bg


def _dense_to_band(Md, num):
    L = Md.shape[0]
    band = np.zeros((num, L))
    for d in range(num):
        idx = np.arange(L - d)
        band[d, idx] = Md[idx, idx + d]
    return band


def _compare_on_band(acc, want, L, num, err_msg=''):
    """Compare a band-space accumulator against a dense-space state on the
    region both represent: pixels (x, x+d) with 0 <= d < num, x < L-d."""
    acc = np.asarray(acc)[:num, :L]
    want_band = _dense_to_band(want, num)
    valid = (np.arange(L)[None, :] < (L - np.arange(num))[:, None])
    np.testing.assert_allclose(np.where(valid, acc, 0.0), want_band,
                               atol=1e-8, err_msg=err_msg)


@pytest.mark.parametrize('pw,ww,maxww', [
    ([2], [5], 8),              # single-p (bhfdr-like)
    ([1, 2, 4], [3, 5, 7], 9),  # multi-p with drift re-adds
])
def test_scan_states_match_reference_replay(pw, ww, maxww):
    L, num = 64, 32
    Md = _band_matrix(L, num, seed=2, lam=2.0)
    band = jnp.asarray(_dense_to_band(Md, num))

    plan = tuple(poolplan.hiccups_pool_plan(pw, ww, maxww))
    states = scan_ops.scan_debug_states(band, band, band, plan)

    replay = _replay_reference_bg(Md, pw, ww, maxww)
    for (entry, (accKc, accKe, accQc, accQe, accR)), ((pi, wi), bK, bY, bR) \
            in zip(zip(plan, states), replay):
        assert (entry.p, entry.w) == (pi, wi)
        for got, want, name in ((accKc, bK, 'K'), (accQc, bY, 'Y'),
                                (accR, bR, 'Reads')):
            _compare_on_band(got, want, L, num,
                             err_msg=f'{name} at (p,w)=({pi},{wi})')


def test_bhfdr_plan_matches_hiccups_single_p():
    """bhfdr's widening loop is the single-p pool with identical ring adds."""
    a = poolplan.bhfdr_pool_plan(2, 5, 9)
    b = poolplan.hiccups_pool_plan([2], [5], 9)
    assert [(e.p, e.w, e.bg_rings, e.reads_rings) for e in a] == \
        [(e.p, e.w, e.bg_rings, e.reads_rings) for e in b]


def _padded_band(Md, num, Lp):
    """Dense [L, L] matrix -> its [num, Lp] band, zero beyond column L."""
    out = np.zeros((num, Lp))
    out[:, :Md.shape[0]] = _dense_to_band(Md, num)
    return out


def _freeze_capture_model(Md, cMd, EMd, num, Lp, cand, pw, ww, maxww, thr,
                          allowed):
    """NumPy model of both scan passes: the literal reference replay
    gives the per-entry Reads/K/Y states of the raw, balanced and
    expected matrices, and the reference's freeze rule (callers.py:
    203-215) is applied to them in band space — a candidate pixel freezes
    at the first entry of its p whose Reads sum reaches ``thr``, and its
    K/Y sums are captured there when that entry is allowed.  Returns
    (per-entry counts, {p: [KS, KE, YS, YE]}) on the [num, Lp] band."""
    band = lambda a: _padded_band(a, num, Lp)
    reads = _replay_reference_bg(Md, pw, ww, maxww)
    sums_c = _replay_reference_bg(cMd, pw, ww, maxww)
    sums_e = _replay_reference_bg(EMd, pw, ww, maxww)
    p_list = sorted(set(pw))
    captured = {p: np.zeros((num, Lp), bool) for p in p_list}
    outs = {p: [np.zeros((num, Lp)) for _ in range(4)] for p in p_list}
    counts = []
    for i, (((pi, _), _, _, bR), (_, Kc, Yc, _), (_, Ke, Ye, _)) in \
            enumerate(zip(reads, sums_c, sums_e)):
        newly = cand & ~captured[pi] & (band(bR) >= thr)
        counts.append(int(newly.sum()))
        cap = newly & allowed[i]
        captured[pi] |= cap
        for t, state in enumerate((Kc, Ke, Yc, Ye)):
            outs[pi][t] = np.where(cap, band(state), outs[pi][t])
    return np.asarray(counts), outs


@pytest.mark.parametrize('num,Lp,L,pw,ww,maxww,thr,gate_last', [
    (64, 256, 243, [2], [5], 7, 16, True),          # capture, gated
    (64, 256, 243, [1, 2], [3, 5], 7, 16, True),    # multi-p drift, gated
    (64, 256, 243, [2], [5], 7, 16, False),         # freeze counts
    (64, 256, 243, [1, 2], [3, 5], 7, 8, False),
    (17, 139, 131, [1, 2], [3, 5], 10, 8, False),   # nothing aligned
    (8, 384, 380, [1, 2], [3, 5], 10, 8, False),    # rows < 2*maxww margin
    (96, 128, 97, [1, 2], [3, 5], 10, 8, False),    # ragged valid extent
])
def test_scan_passes_match_numpy_model(num, Lp, L, pw, ww, maxww, thr,
                                       gate_last):
    """Pass A's per-entry freeze counts and pass B's captured K/Y sums
    equal an independent NumPy model built on the literal reference
    replay, including the controller's gating of the last entry and
    shapes where nothing is aligned."""
    rng = np.random.default_rng(num * 1000 + Lp)
    Md = np.zeros((L, L))
    EMd = np.zeros((L, L))
    for d in range(num):
        idx = np.arange(L - d)
        Md[idx, idx + d] = (rng.random(L - d) < 0.5) * rng.poisson(5.0, L - d)
        if d >= min(ww):
            EMd[idx, idx + d] = rng.uniform(0.5, 3.0)
    cMd = Md * rng.random((L, L))
    raw, cband, eband = (_padded_band(a, num, Lp) for a in (Md, cMd, EMd))
    drow = np.arange(num)[:, None]
    col = np.arange(Lp)[None, :]
    cand = (raw != 0) & (drow >= min(ww)) & (col < L - drow)
    plan = tuple(poolplan.hiccups_pool_plan(pw, ww, maxww))
    p_list = tuple(sorted(set(pw)))
    allowed = np.ones(len(plan), bool)
    allowed[-1] = not gate_last

    want_counts, want_outs = _freeze_capture_model(
        Md, cMd, EMd, num, Lp, cand, pw, ww, maxww, thr, allowed)
    all_on = np.ones(len(plan), bool)
    counts_a = scan_ops.scan_pass_a(jnp.asarray(raw), jnp.asarray(cand),
                                    plan, p_list, thr)
    np.testing.assert_array_equal(
        np.asarray(counts_a),
        _freeze_capture_model(Md, cMd, EMd, num, Lp, cand, pw, ww, maxww,
                              thr, all_on)[0])
    counts_b, _, outs = scan_ops.scan_pass_b(
        jnp.asarray(raw), jnp.asarray(cband), jnp.asarray(eband),
        jnp.asarray(cand), jnp.asarray(allowed), plan, p_list, thr)
    np.testing.assert_array_equal(np.asarray(counts_b), want_counts)
    for p in p_list:
        for t, name in enumerate(('KS', 'KE', 'YS', 'YE')):
            np.testing.assert_allclose(np.asarray(outs[p][t]),
                                       want_outs[p][t], rtol=1e-12,
                                       atol=1e-9, err_msg=f'p={p} {name}')
