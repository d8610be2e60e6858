"""The widening ring scan — the engine's hot loop.

Replaces the reference's per-(p,w) sparse shifted-diagonal accumulation
(callers.py:132-232, the dominant cost per SURVEY §3.2) with an
incremental scan over *square rings* on dense band tensors.  For a pixel
(x, y=x+d), window cell (a, b) reads ``band[d + b - a, x + a]`` (zero
outside the band/chromosome), so ring sums decompose into shifted adds of
a handful of running line accumulators:

  Vx_r[e,t] = sum_{0<|b|<=r}  band[e+b, t]        (vertical, no center)
  Wx_r[e,t] = sum_{0<|a|<=r}  band[e-a, t+a]      (anti-diagonal, no center)
  Vn_r[e,t] = sum_{-r<=b<=-1} band[e+b, t]        (vertical, negative half)
  Wq_r[e,t] = sum_{1<=a<=r}   band[e-a, t+a]      (anti-diagonal, pos half)

  ringK_r[d,x] (all non-cross cells at radius r)
      = Vx_r[d-r, x+r] + Vx_r[d+r, x-r] + Wx_{r-1}[d+r, x] + Wx_{r-1}[d-r, x]
  ringQ_r[d,x] (lower-left quadrant cells at radius r)
      = Vn_r[d-r, x+r] + Wq_{r-1}[d-r, x]

Each scan step costs O(1) array passes instead of O(w) sparse matrix
constructions, and every accumulator is a cancellation-free sum of
nonnegative terms (float-accurate, unlike prefix-sum differencing).
The pool plan (core/poolplan.py) dictates which rings feed the background
accumulators at each entry, reproducing the reference's exact state
including its multi-pw drift.

Two passes per chromosome:
  * pass A replays only the raw lower-left 'Reads' state and counts
    freshly-frozen pixels per pool entry (for the controller's early-stop
    emulation, callers.py:203-232);
  * pass B replays everything and captures each pixel's K/Y background
    sums at its freeze entry, gated by the controller's `allowed` vector.
"""
from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp

from ..core.poolplan import PoolEntry


def shift2(a, dd, dx):
    """out[i, j] = a[i + dd, j + dx], zero-filled outside bounds.

    Implemented as pad+slice (cheap, fusible) rather than scatter."""
    n, m = a.shape
    if abs(dd) >= n or abs(dx) >= m:
        return jnp.zeros_like(a)
    top, bot = max(-dd, 0), max(dd, 0)
    left, right = max(-dx, 0), max(dx, 0)
    padded = jnp.pad(a, ((top, bot), (left, right)))
    return jax.lax.slice(padded, (dd + top, dx + left), (dd + top + n, dx + left + m))


class _RingState:
    """Incremental line accumulators for one band tensor.

    ``kinds`` restricts which ring flavours this band will ever be asked
    for: the raw 'm' band only serves lower-left 'Q' rings (reads_rings),
    so its K-side accumulators (Vx, Wx — 6 shifted adds per advance) are
    skipped entirely when 'K' is absent."""

    def __init__(self, band, kinds=('K', 'Q')):
        self.band = band
        z = jnp.zeros_like(band)
        self.Vx, self.Wx, self.Vn, self.Wq = z, z, z, z
        self.need_K = 'K' in kinds
        self.need_Q = 'Q' in kinds
        self.r = 0

    def advance(self):
        r = self.r + 1
        band = self.band
        neg = shift2(band, -r, 0)
        if self.need_K:
            self.Vx = self.Vx + shift2(band, r, 0) + neg
        if self.need_Q:
            self.Vn = self.Vn + neg
        # ring sums use Wx/Wq at r-1 (pre-update)
        if self.need_K:
            self._ringK = (shift2(self.Vx, -r, r) + shift2(self.Vx, r, -r)
                           + shift2(self.Wx, r, 0) + shift2(self.Wx, -r, 0))
        if self.need_Q:
            self._ringQ = shift2(self.Vn, -r, r) + shift2(self.Wq, -r, 0)
        anti = shift2(band, -r, r)
        if self.need_K:
            self.Wx = self.Wx + anti + shift2(band, r, -r)
        if self.need_Q:
            self.Wq = self.Wq + anti
        self.r = r

    def ringK(self):
        return self._ringK

    def ringQ(self):
        return self._ringQ


class _RingProvider:
    """Serves ring sums in pool-plan request order, advancing the line
    accumulators lazily.  Any ring that will be requested again later
    (either by another band in the same entry or by a multi-pw drift
    re-add at a later entry) is cached until its final use, so peak extra
    memory stays at a handful of small-radius rings."""

    def __init__(self, bands: dict, pending):
        """``pending``: Counter of (r, kind, which) -> total request count."""
        kinds = {k: {wh for (_, kk, wh) in pending if kk == k}
                 for k in bands}
        self.states = {k: _RingState(v, kinds[k] or {'K', 'Q'})
                       for k, v in bands.items()}
        self.pending = dict(pending)
        self.cache = {}
        self.r_cur = 0

    def get(self, r, kind, which):
        key = (r, kind, which)
        while self.r_cur < r:
            self.r_cur += 1
            for k, st in self.states.items():
                st.advance()
                for wh, fn in (('K', st.ringK), ('Q', st.ringQ)):
                    ck = (self.r_cur, k, wh)
                    if self.pending.get(ck, 0) > 0:
                        self.cache[ck] = fn()
        assert key in self.cache, f'ring {key} requested but never planned'
        val = self.cache[key]
        self.pending[key] -= 1
        if self.pending[key] == 0:
            del self.cache[key]
        return val


def _ring_mentions(plan: Sequence[PoolEntry], with_captures=True):
    """Request counts of (r, band, which) tuples over the whole plan."""
    from collections import Counter
    c = Counter()
    for e in plan:
        if with_captures:
            for r in e.bg_rings:
                for kind in ('c', 'e'):
                    for wh in ('K', 'Q'):
                        c[(r, kind, wh)] += 1
        for r in e.reads_rings:
            c[(r, 'm', 'Q')] += 1
    return c


def _row_margin(plan):
    """Ring reads reach +-r into the accumulators, which themselves reach
    +-r into the band: rows beyond the [0, num) band carry semantically
    nonzero accumulator values, so the scan runs on a domain padded by
    2*maxww zero rows on each side."""
    return 2 * max(e.w for e in plan)


def _scan_core(raw, cband, eband, cand_mask, plan, p_list, thr, allowed,
               with_captures: bool):
    """Ring-scan math on row-pre-padded arrays (margin handling belongs to
    the caller).  Returns per-entry counts as a Python list of scalars
    (plus captured masks and outputs with captures)."""
    bands = {'m': raw}
    if with_captures:
        bands['c'] = cband
        bands['e'] = eband
    provider = _RingProvider(bands, _ring_mentions(plan, with_captures))

    zero = jnp.zeros(cand_mask.shape, raw.dtype)
    accR = zero
    captured = {p: jnp.zeros(cand_mask.shape, bool) for p in p_list}
    counts = []
    if with_captures:
        accKc = accKe = accQc = accQe = zero
        outs = {p: [zero, zero, zero, zero] for p in p_list}  # KS, KE, YS, YE

    for e in plan:
        if with_captures:
            for r in e.bg_rings:
                accKc = accKc + provider.get(r, 'c', 'K')
                accKe = accKe + provider.get(r, 'e', 'K')
                accQc = accQc + provider.get(r, 'c', 'Q')
                accQe = accQe + provider.get(r, 'e', 'Q')
        for r in e.reads_rings:
            accR = accR + provider.get(r, 'm', 'Q')

        p = e.p
        newly = cand_mask & (~captured[p]) & (accR >= thr)
        counts.append(jnp.sum(newly.astype(jnp.int32)))
        ok = allowed[e.index]
        do_cap = newly & ok
        captured[p] = captured[p] | do_cap
        if with_captures:
            o = outs[p]
            vals = (accKc, accKe, accQc, accQe)
            outs[p] = [jnp.where(do_cap, v, old) for v, old in zip(vals, o)]

    if with_captures:
        return counts, captured, outs
    return counts


def _scan(raw, cband, eband, cand_mask, plan, p_list, thr, allowed,
          with_captures: bool):
    """Shared implementation of passes A and B (traced under jit)."""
    M = _row_margin(plan)
    pad = lambda a: jnp.pad(a, ((M, M), (0, 0)))
    out = _scan_core(pad(raw),
                     pad(cband) if with_captures else None,
                     pad(eband) if with_captures else None,
                     pad(cand_mask), plan, p_list, thr, allowed,
                     with_captures)
    crop = lambda a: a[M:-M]
    if with_captures:
        counts, captured, outs = out
        captured = {p: crop(v) for p, v in captured.items()}
        outs = {p: [crop(v) for v in o] for p, o in outs.items()}
        return jnp.stack(counts), captured, outs
    return jnp.stack(out)


@functools.partial(jax.jit, static_argnames=('plan', 'p_list', 'thr'))
def scan_pass_a(raw, cand_mask, plan, p_list, thr):
    """Freeze-count pass: per-entry freshly-frozen pixel counts with no
    truncation (every entry allowed)."""
    allowed = jnp.ones(len(plan), bool)
    return _scan(raw, None, None, cand_mask, plan, p_list, thr, allowed, False)


@functools.partial(jax.jit, static_argnames=('plan', 'p_list', 'thr'))
def scan_pass_b(raw, cband, eband, cand_mask, allowed, plan, p_list, thr):
    """Capture pass: per-p frozen background sums (bSV/bEV for the donut 'K'
    and lower-left 'Y' filters), honouring the controller's allowed mask."""
    counts, captured, outs = _scan(raw, cband, eband, cand_mask, plan, p_list,
                                   thr, allowed, True)
    return counts, captured, outs


@functools.partial(jax.jit, static_argnames=('plan',))
def scan_debug_states(raw, cband, eband, plan):
    """Testing hook: the (K_c, K_e, Y_c, Y_e, Reads) accumulator states after
    each pool entry, for comparison against a literal replay of the
    reference's incremental branches."""
    M = _row_margin(plan)
    pad = lambda a: jnp.pad(a, ((M, M), (0, 0)))
    provider = _RingProvider({'m': pad(raw), 'c': pad(cband), 'e': pad(eband)},
                             _ring_mentions(plan, True))
    zero = pad(jnp.zeros_like(raw))
    accKc = accKe = accQc = accQe = accR = zero
    states = []
    for e in plan:
        for r in e.bg_rings:
            accKc = accKc + provider.get(r, 'c', 'K')
            accKe = accKe + provider.get(r, 'e', 'K')
            accQc = accQc + provider.get(r, 'c', 'Q')
            accQe = accQe + provider.get(r, 'e', 'Q')
        for r in e.reads_rings:
            accR = accR + provider.get(r, 'm', 'Q')
        states.append(tuple(a[M:-M] for a in (accKc, accKe, accQc, accQe, accR)))
    return states
