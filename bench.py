#!/usr/bin/env python
"""Benchmark: hiccups chromosome throughput on one GPU.

A synthetic chromosome at 10 Kb (L = 8192 bins, 2 Mb search span,
pw 2 / ww 5 / maxww 10, seed 0) runs the production one-program
chromosome pipeline (engine.fused_hiccups_launch: device sheets, pass A,
the on-device freeze emulation, pass B, the fused compact scorers for
both backgrounds).  Its steady time is the median of repeated calls,
each ending in ``block_until_ready``; candidate pixels scored per second
is the headline.  The production engine's peak table on the same bands
is then checked against the float64 oracle (tests/oracle/
reference_impl.py): identical loci and geometry, statistics to 1e-8.

Prints ONE JSON line to stdout:
  {"metric": ..., "value": N, "unit": "pixels/s", "vs_baseline": N,
   "parity": {...}, "device": {"platform", "kind", "count"}, ...}
Progress goes to stderr.  Exits non-zero without a JSON line when JAX
finds no GPU.

Baseline: the reference CPU implementation scores ~20K candidate
pixels/s (K562 10Kb pyHICCUPS: 139.9M band pixels / 7053 s,
BASELINE.md).  Environment knobs: HICPEAKS_BENCH_L (bins),
HICPEAKS_BENCH_SPAN (bp), HICPEAKS_BENCH_ITERS.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
RES = 10000


def log(msg):
    print(f'[bench] {msg}', file=sys.stderr, flush=True)


def require_gpu():
    """jax.devices() when the first device is a GPU; otherwise exit
    non-zero (a CPU run is never reported as a device measurement)."""
    import jax
    devices = jax.devices()
    if devices[0].platform != 'gpu':
        sys.exit(f'no GPU: JAX found {devices}; this measures the card')
    return devices


def device_info(devices):
    return {'platform': devices[0].platform, 'kind': devices[0].device_kind,
            'count': len(devices)}


def card_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()


def bench_bands(L=8192, maxapart=2_000_000, ww_min=5, maxww=10, seed=0):
    """(bands, weights, bias) of the benchmark chromosome: synthetic
    counts at 10 Kb with 200 planted loops, weights = 1/bias (NaN at gap
    bins)."""
    from hicpeaks_tpu.io.synth import synthesize_chrom
    from hicpeaks_tpu.ops.band import build_bands
    num = maxapart // RES + maxww + 1
    b1, b2, ct, _, bias = synthesize_chrom(
        n_bins=L, res=RES, seed=seed, depth=40.0, n_loops=200, decay=0.75,
        max_loop_span_bins=min(200, num - maxww - 2))
    w = np.full(L, np.nan)
    ok = bias > 0
    w[ok] = 1.0 / bias[ok]
    bands = build_bands(b1, b2, ct, w, L, num, ww_min, RES,
                        dtype=np.float32)
    return bands, w, bias


def oracle_parity(bands, w, bias, cfg):
    """Production engine (exact mode) vs the float64 oracle on the same
    bands: identical loci and cluster geometry, statistics to 1e-8."""
    from hicpeaks_tpu.core import engine
    sys.path.insert(0, os.path.join(ROOT, 'tests'))
    from oracle import reference_impl as oracle

    t0 = time.perf_counter()
    table = engine.hiccups_chrom(bands, cfg)
    t_engine = time.perf_counter() - t0

    t0 = time.perf_counter()
    L, num = int(bands.L), int(bands.num)
    raw64 = np.asarray(bands.raw[:, :L], np.float64)
    w64 = np.asarray(w, np.float64)            # NaN at invalid bins
    Md = np.zeros((L, L))
    cMd = np.zeros((L, L))
    IR = {}
    idx = np.arange(L)
    for d in range(num):
        Md[idx[:L - d], idx[:L - d] + d] = raw64[d, :L - d]
    for d in range(min(cfg.ww), num):
        # sparse-fetch semantics (tests/oracle/prep.py): a pixel with no
        # stored count is 0.0 in the balanced diagonal — it enters the IR
        # mean — while NaN (excluded) marks only STORED pixels at
        # invalid-weight bins
        rr = raw64[d, :L - d]
        cdiag = rr * w64[:L - d] * w64[d:L]
        cdiag[rr == 0] = 0.0
        mask = np.isnan(cdiag)
        IR[d] = cdiag[~mask].mean()
        cMd[idx[:L - d], idx[:L - d] + d] = np.where(mask, 0.0, cdiag)
    B = np.where(bias > 0, bias, 0.0)
    want = oracle.hiccups(
        Md, cMd, B, B, IR, L, num, pw=cfg.pw, ww=cfg.ww, sig=cfg.siglevel,
        sumq=cfg.sumq, maxww=cfg.maxww, maxapart=cfg.maxapart, res=RES,
        min_marginal_peaks=cfg.min_marginal_peaks,
        min_local_reads=cfg.min_local_reads, onlyanchor=cfg.only_anchors)
    t_oracle = time.perf_counter() - t0

    loci_ok = set(table) == set(want)
    geom_ok = True
    max_rel = 0.0
    for k in set(table) & set(want):
        g = np.asarray(table[k][3:], float)
        v = np.asarray(want[k][3:], float)
        geom_ok &= tuple(table[k][:3]) == tuple(want[k][:3])
        max_rel = max(max_rel, float(np.max(
            np.abs(g - v) / np.maximum(np.abs(v), 1e-30))))
    return {
        'ok': bool(loci_ok and geom_ok and max_rel <= 1e-8 and want),
        'loci_identical': bool(loci_ok),
        'geometry_identical': bool(geom_ok),
        'max_rel_stat_diff': max_rel,
        'engine_peaks': len(table),
        'oracle_peaks': len(want),
        'engine_wall_s': t_engine,
        'oracle_wall_s': t_oracle,
    }


def fused_plan(bands, cfg):
    """(plan, candidate total, o_cap) of the production one-program
    hiccups chromosome for these bands, as engine.hiccups_chrom derives
    them."""
    from hicpeaks_tpu.core import engine, poolplan
    plan = tuple(poolplan.hiccups_pool_plan(cfg.pw, cfg.ww, cfg.maxww))
    total = bands.candidate_total(min(cfg.ww), cfg.maxapart // bands.res)
    _, o_cap = engine._bh_plan(True, 'auto', bands.max_count)
    return plan, total, o_cap


def time_fused(bands, cfg, n_iters):
    """(first-call seconds incl. compile, median steady seconds,
    candidate total) of the production one-program chromosome, each call
    ending in block_until_ready."""
    import jax
    from hicpeaks_tpu.core import engine
    plan, total, o_cap = fused_plan(bands, cfg)

    def call():
        return jax.block_until_ready(
            engine.fused_hiccups_launch(bands, cfg, plan, total, o_cap))

    t0 = time.perf_counter()
    call()
    first = time.perf_counter() - t0
    steady = []
    for _ in range(n_iters):
        t0 = time.perf_counter()
        call()
        steady.append(time.perf_counter() - t0)
    return first, float(np.median(steady)), total


def main():
    devices = require_gpu()
    from hicpeaks_tpu.cli.common import enable_compilation_cache
    from hicpeaks_tpu.core.config import HiccupsConfig
    cache = enable_compilation_cache()
    card = card_line()
    log(f'devices: {devices}; card: {card}; compile cache: {cache}')

    L = int(os.environ.get('HICPEAKS_BENCH_L', 8192))
    maxapart = int(os.environ.get('HICPEAKS_BENCH_SPAN', 2_000_000))
    n_iters = int(os.environ.get('HICPEAKS_BENCH_ITERS', 10))
    cfg = HiccupsConfig(pw=(2,), ww=(5,), maxww=10, maxapart=maxapart)
    bands, w, bias = bench_bands(L, maxapart)
    first, dt, n_cand = time_fused(bands, cfg, n_iters)
    log(f'fused program: first call {first:.1f}s (compile), steady '
        f'{dt * 1e3:.3f} ms over {n_iters} calls')
    parity = oracle_parity(bands, w, bias, cfg)
    log(f'parity vs float64 oracle: {parity}')
    pixels_per_s = n_cand / dt
    print(json.dumps({
        'metric': f'pixels-scored/s/chip (hiccups fused program, '
                  f'{n_cand} candidates, L={L}@10Kb, '
                  f'{maxapart // 1_000_000}Mb span)',
        'value': pixels_per_s,
        'unit': 'pixels/s',
        'vs_baseline': pixels_per_s / 20_000.0,
        'steady_ms': dt * 1e3,
        'first_call_s': first,
        'parity': parity,
        'card': card,
        'device': device_info(devices),
    }), flush=True)
    return 0 if parity['ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
