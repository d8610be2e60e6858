"""Dense float64 oracle of the reference peak callers.

A control-flow-faithful NumPy re-implementation of ``hiccups()`` and
``bhfdr()`` (reference hicpeaks/callers.py:44-590) used as the golden
reference for the device engine's tests.  Sparse shifted-diagonal arithmetic
is replaced by shifted dense-array accumulation, but every conditional of
the reference — the limitCompute incremental add/subtract branches, the
per-pixel freeze bookkeeping, the lambda-chunk boundaries, the gap-filter
ranges, the Y-background postcheck — is reproduced verbatim in offset
coordinates.

Offset convention: window cell (i, j) of the reference's (2w+1)^2 window
maps to (a, b) = (i - w, j - w), so
  P1  <=> |a| <= p and |b| <= p                       (callers.py:138)
  P2  <=> a >= 1 and b <= -1 and not (a <= p and b >= -p)  (callers.py:139-141)
  bgloc = max(|a|, |b|)                                (callers.py:149)
and cell (a, b)'s contribution to pixel (x, y) is M'[x+a, y+b] of the
zero-padded upper-band matrix (callers.py:143-198 slicing semantics).
"""
from __future__ import annotations

import numpy as np
from scipy.stats import poisson

from hicpeaks_tpu.core.clustering import local_clustering
from .multitest import fdr_bh


def _pw_ww_pairs(pw, ww, maxww):
    pool = []
    for p, w in zip(pw, ww):
        for i in range(w, maxww + 1):
            pool.append((i, p))
    return [(i[1], i[0]) for i in sorted(pool)]


def lambdachunk(E):
    if E.size == 0:
        return []
    numbin = int(np.ceil(np.log(E.max()) / np.log(2) * 3 + 1))
    chunks = []
    for i in range(1, numbin + 1):
        if i == 1:
            lv, rv = 0, 1
        else:
            lv = np.power(2, ((i - 2) / 3.))
            rv = np.power(2, ((i - 1) / 3.))
        idx = np.where((E > lv) & (E < rv))[0]
        chunks.append((lv, rv, idx))
    return chunks


class _Padded:
    """Zero-padded dense matrix with shifted-slice reads."""

    def __init__(self, dense, pad):
        L = dense.shape[0]
        self.L, self.pad = L, pad
        self.arr = np.zeros((L + 2 * pad, L + 2 * pad), dense.dtype)
        self.arr[pad:pad + L, pad:pad + L] = dense

    def shifted(self, a, b):
        p, L = self.pad, self.L
        return self.arr[p + a:p + a + L, p + b:p + b + L]


def _accumulate(dst, src: _Padded, cells, sign=1.0):
    for (a, b) in cells:
        if sign > 0:
            dst += src.shifted(a, b)
        else:
            dst -= src.shifted(a, b)


def _in_P1(a, b, p):
    return abs(a) <= p and abs(b) <= p


def _in_P2(a, b, p, w):
    return (1 <= a <= w) and (-w <= b <= -1) and not (a <= p and b >= -p)


def _gap_filter(xi, yi, gaps, s, chromLen):
    """callers.py:291-312 / 556-577 — note the exclusive upper bound."""
    keep = []
    for i in range(xi.size):
        lower = (xi[i] - s) if (xi[i] > s) else 0
        upper = (xi[i] + s) if ((xi[i] + s) < chromLen) else (chromLen - 1)
        region = set(range(lower, upper))
        lower = (yi[i] - s) if (yi[i] > s) else 0
        upper = (yi[i] + s) if ((yi[i] + s) < chromLen) else (chromLen - 1)
        region |= set(range(lower, upper))
        if not (region & gaps):
            keep.append(i)
    return keep


def hiccups(Md, cMd, B1, B2, IR, chromLen, num, chrom='X', pw=(2,), ww=(5,),
            maxww=20, sig=0.1, sumq=0.01, double_fold=1.75, single_fold=2,
            maxapart=2000000, res=10000, use_raw=False, min_marginal_peaks=3,
            onlyanchor=True, min_local_reads=25):
    """Oracle of callers.py:44-362.  ``Md``/``cMd`` are dense [L, L] float64
    carrying only the upper diagonals the reference's sparse matrices hold
    (0..num-1 and min(ww)..num-1 respectively, NaN already zeroed)."""
    pw, ww = list(pw), list(ww)
    x = np.asarray(sorted(IR))
    EMd = np.zeros_like(Md)
    for d in x:
        idx = np.arange(chromLen - d)
        EMd[idx, idx + d] = IR[d]

    Mp = _Padded(Md, maxww)
    cMp = _Padded(cMd, maxww)
    EMp = _Padded(EMd, maxww)

    p_w = _pw_ww_pairs(pw, ww, maxww)

    vxi, vyi = np.nonzero(Md)
    band = (vyi - vxi >= min(ww)) & (vyi - vxi <= maxapart // res)
    vxi, vyi = vxi[band], vyi[band]

    flocals = ['K', 'Y']
    bSV = {p: {fl: np.zeros(vxi.size) for fl in flocals} for p in pw}
    bEV = {p: {fl: np.zeros(vxi.size) for fl in flocals} for p in pw}
    RefIdx = {p: np.arange(vxi.size) for p in pw}
    iniNum = {p: vxi.size for p in pw}
    totalNum = vxi.size

    bS = {fl: np.zeros((chromLen, chromLen)) for fl in flocals}
    bE = {fl: np.zeros((chromLen, chromLen)) for fl in flocals}
    Reads = np.zeros((chromLen, chromLen))

    limitCompute = False
    last_pi = last_wi = 0
    frozen_w = maxww
    p_min = min(pw)
    for pi, wi in p_w:
        if wi > frozen_w:
            continue
        add_K, sub_K, add_Y, sub_Y, add_R = [], [], [], [], []
        for a in range(-wi, wi + 1):
            for b in range(-wi, wi + 1):
                bgloc = max(abs(a), abs(b))
                if limitCompute:
                    if ((bgloc <= last_wi) and (bgloc > max(pi, last_pi))) or \
                       (bgloc <= min(pi, last_pi)):
                        continue
                positive = ((not limitCompute) or (bgloc > last_wi) or
                            (bgloc > pi and bgloc <= last_pi))
                if (a != 0) and (b != 0) and not _in_P1(a, b, pi) \
                        and not _in_P2(a, b, pi, wi):
                    (add_K if positive else sub_K).append((a, b))
                if _in_P2(a, b, pi, wi):
                    (add_K if positive else sub_K).append((a, b))
                    (add_Y if positive else sub_Y).append((a, b))
                    if (not limitCompute) or (pi == p_min and bgloc > last_wi):
                        add_R.append((a, b))
        _accumulate(bS['K'], cMp, add_K, 1.0)
        _accumulate(bE['K'], EMp, add_K, 1.0)
        _accumulate(bS['K'], cMp, sub_K, -1.0)
        _accumulate(bE['K'], EMp, sub_K, -1.0)
        _accumulate(bS['Y'], cMp, add_Y, 1.0)
        _accumulate(bE['Y'], EMp, add_Y, 1.0)
        _accumulate(bS['Y'], cMp, sub_Y, -1.0)
        _accumulate(bE['Y'], EMp, sub_Y, -1.0)
        _accumulate(Reads, Mp, add_R, 1.0)

        limitCompute = True
        last_pi, last_wi = pi, wi

        Txi, Tyi = vxi[RefIdx[pi]], vyi[RefIdx[pi]]
        RNums = Reads[Txi, Tyi]
        EIdx = RefIdx[pi][RNums >= min_local_reads]
        Valid_Ratio = EIdx.size / float(iniNum[pi])
        Exi, Eyi = vxi[EIdx], vyi[EIdx]
        for fl in flocals:
            bSV[pi][fl][EIdx] = bS[fl][Exi, Eyi]
            bEV[pi][fl][EIdx] = bE[fl][Exi, Eyi]
        RefIdx[pi] = RefIdx[pi][RNums < min_local_reads]
        iniNum[pi] = RefIdx[pi].size
        left_Ratio = iniNum[pi] / float(totalNum)
        if (Valid_Ratio < 0.3) and (wi >= max(ww)):
            frozen_w = wi
        if (left_Ratio < 0.03) and (wi >= max(ww)):
            frozen_w = wi

    pixel_table = {}
    gaps = set(np.where(cMd.sum(axis=1) == 0)[0])
    for pi, wi in zip(pw, ww):
        xpos, ypos, Ovalues, ICE = {}, {}, {}, {}
        Fold, pvalues, qvalues = {}, {}, {}
        cEM = None
        for fl in flocals:
            Mask = (bEV[pi][fl] != 0) & (vyi - vxi >= wi)
            ratio = np.zeros((chromLen, chromLen))
            ratio[vxi[Mask], vyi[Mask]] = bSV[pi][fl][Mask] / bEV[pi][fl][Mask]
            cEM = EMd * ratio
            xi, yi = np.nonzero(cEM)
            Evalues = cEM[xi, yi] * B1[xi] * B2[yi]
            Mask = Evalues > 0
            Evalues, xi, yi = Evalues[Mask], xi[Mask], yi[Mask]
            Ovalues[fl] = Md[xi, yi]
            ICE[fl] = cMd[xi, yi]
            Fold[fl] = Ovalues[fl] / Evalues

            pvalue = np.ones(xi.size)
            qvalue = np.ones(xi.size)
            for lv, rv, cidx in lambdachunk(Evalues):
                if cidx.size > 0:
                    chunkP = 1 - poisson(rv).cdf(Ovalues[fl][cidx])
                    pvalue[cidx] = chunkP
                    qvalue[cidx] = fdr_bh(chunkP, sig)[1]

            reject = qvalue <= sig
            qvalue, pvalue = qvalue[reject], pvalue[reject]
            Ovalues[fl], ICE[fl] = Ovalues[fl][reject], ICE[fl][reject]
            Evalues, Fold[fl] = Evalues[reject], Fold[fl][reject]
            xi, yi = xi[reject], yi[reject]

            if len(gaps) > 0:
                fIdx = _gap_filter(xi, yi, gaps, min(ww), chromLen)
                xi, yi = xi[fIdx], yi[fIdx]
                Ovalues[fl], ICE[fl] = Ovalues[fl][fIdx], ICE[fl][fIdx]
                pvalue, qvalue = pvalue[fIdx], qvalue[fIdx]
                Fold[fl], Evalues = Fold[fl][fIdx], Evalues[fIdx]

            xpos[fl], ypos[fl] = xi, yi
            pvalues[fl], qvalues[fl] = pvalue, qvalue

        if use_raw:
            preDonuts = dict(zip(zip(xpos['K'], ypos['K']),
                                 zip(Ovalues['K'], Ovalues['K'], Fold['K'],
                                     pvalues['K'], qvalues['K'])))
        else:
            preDonuts = dict(zip(zip(xpos['K'], ypos['K']),
                                 zip(ICE['K'], Ovalues['K'], Fold['K'],
                                     pvalues['K'], qvalues['K'])))
        preLL = dict(zip(zip(xpos['Y'], ypos['Y']),
                         zip(ICE['Y'], Ovalues['Y'], Fold['Y'],
                             pvalues['Y'], qvalues['Y'])))

        commonPos = set(preDonuts) & set(preLL)
        for ci, cj in set(preDonuts) - set(preLL):
            if cEM[ci, cj] == 0:   # cEM still holds the 'Y' expected matrix
                commonPos.add((ci, cj))

        for key in commonPos:
            donut = preDonuts[key]
            ll = preLL.get(key, donut)
            bpkey = (key[0] * res, key[1] * res)
            if (donut[2] > double_fold) and (ll[2] > double_fold) and \
                    ((donut[2] > single_fold) or (ll[2] > single_fold)):
                if bpkey not in pixel_table:
                    pixel_table[bpkey] = bpkey + (0,) + donut + ll[2:]
                else:
                    if (donut[-1] < pixel_table[bpkey][7]) and \
                            (ll[-1] < pixel_table[bpkey][10]):
                        pixel_table[bpkey] = bpkey + (0,) + donut + ll[2:]

    Donuts = {(k[0] // res, k[1] // res): pixel_table[k][3:8] for k in pixel_table}
    LL = {(k[0] // res, k[1] // res): pixel_table[k][8:] for k in pixel_table}
    peak_list = local_clustering(Donuts, LL, res, min_count=min_marginal_peaks,
                                 r=2 * res, sumq=sumq, onlysummit=onlyanchor)
    final_table = {}
    for pixel, cen, radius in peak_list:
        key = (pixel[0] * res, pixel[1] * res)
        final_table[key] = (cen[0] * res, cen[1] * res) + (radius * res,) + \
            pixel_table[key][4:]
    return final_table


def bhfdr(Md, cMd, B1, B2, IR, chromLen, num, chrom='X', pw=2, ww=5, sig=0.05,
          maxww=20, maxapart=2000000, res=10000, min_marginal_peaks=3,
          onlyanchor=False):
    """Oracle of callers.py:364-590 (donut-only background, fixed freeze
    threshold 16, one global BH, post-clustering Fold>2 gate)."""
    x = np.asarray(sorted(IR))
    EMd = np.zeros_like(Md)
    for d in x:
        idx = np.arange(chromLen - d)
        EMd[idx, idx + d] = IR[d]
    Mp = _Padded(Md, maxww)
    cMp = _Padded(cMd, maxww)
    EMp = _Padded(EMd, maxww)

    xi0, yi0 = np.nonzero(Md)
    band = (yi0 - xi0 >= ww) & (yi0 - xi0 <= maxapart // res)
    xi, yi = xi0[band], yi0[band]
    bSV = np.zeros(xi.size)
    bEV = np.zeros(xi.size)
    RefIdx = np.arange(xi.size)
    RefMask = np.ones(xi.size, dtype=bool)
    iniNum = totalNum = xi.size

    bS = np.zeros((chromLen, chromLen))
    bE = np.zeros((chromLen, chromLen))
    Reads = np.zeros((chromLen, chromLen))
    limitCompute = False
    for w in range(ww, maxww + 1):
        add_bg, add_R = [], []
        for a in range(-w, w + 1):
            for b in range(-w, w + 1):
                bgloc = max(abs(a), abs(b))
                if limitCompute and (bgloc < w):
                    continue
                if (a != 0) and (b != 0) and not _in_P1(a, b, pw):
                    add_bg.append((a, b))
                if _in_P2(a, b, pw, w):
                    add_R.append((a, b))
        limitCompute = True
        _accumulate(bS, cMp, add_bg, 1.0)
        _accumulate(bE, EMp, add_bg, 1.0)
        _accumulate(Reads, Mp, add_R, 1.0)

        Txi, Tyi = xi[RefIdx], yi[RefIdx]
        RNums = Reads[Txi, Tyi]
        EIdx = RefIdx[RNums >= 16]
        Valid_Ratio = EIdx.size / float(iniNum)
        bSV[EIdx] = bS[xi[EIdx], yi[EIdx]]
        bEV[EIdx] = bE[xi[EIdx], yi[EIdx]]
        RefIdx = RefIdx[RNums < 16]
        iniNum = RefIdx.size
        left_Ratio = iniNum / float(totalNum)
        if Valid_Ratio < 0.3:
            break
        if left_Ratio < 0.03:
            break

    RefMask[RefIdx] = False
    Mask = (bEV != 0) & RefMask
    xi_m, yi_m = xi[Mask], yi[Mask]
    ratio = np.zeros((chromLen, chromLen))
    ratio[xi_m, yi_m] = bSV[Mask] / bEV[Mask]
    cEM = EMd * ratio

    xi, yi = np.nonzero(cEM)
    Evalues = cEM[xi, yi] * B1[xi] * B2[yi]
    Mask = Evalues > 0
    Evalues, xi, yi = Evalues[Mask], xi[Mask], yi[Mask]
    Ovalues = Md[xi, yi]
    pvalues = 1 - poisson(Evalues).cdf(Ovalues)
    Fold = Ovalues / Evalues

    reject, qall = fdr_bh(pvalues, sig)
    xpos, ypos = xi[reject], yi[reject]
    pvals, qvals = pvalues[reject], qall[reject]
    Ovals, Folds = Ovalues[reject], Fold[reject]

    gaps = set(np.where(cMd.sum(axis=1) == 0)[0])
    if len(gaps) > 0:
        fIdx = _gap_filter(xpos, ypos, gaps, ww, chromLen)
        xpos, ypos = xpos[fIdx], ypos[fIdx]
        pvals, qvals = pvals[fIdx], qvals[fIdx]
        Ovals, Folds = Ovals[fIdx], Folds[fIdx]

    Donuts = dict(zip(zip(xpos, ypos), zip(Ovals, Folds, pvals, qvals)))
    pixel_list = local_clustering(Donuts, None, res, min_count=min_marginal_peaks,
                                  r=2 * res, onlysummit=onlyanchor)
    pixel_table = {}
    for pixel, cen, radius in pixel_list:
        donut = Donuts[pixel]
        if donut[1] > 2:
            pixel_table[(pixel[0] * res, pixel[1] * res)] = \
                (cen[0] * res, cen[1] * res) + (radius * res,) + donut
    return pixel_table
