#!/usr/bin/env python
"""Genome-scale benchmark at the reference's default hiccups config.

Runs the full production per-chromosome pipeline (pass A freeze counts,
capture pass, corrected expectations, lambda-chunk Poisson + BH, gap
filter, controller clustering) on a chr1-scale synthetic chromosome:
L = 24,900 bins @ 10Kb (249 Mb) with maxapart = 10 Mb -> num = 1011
diagonals — the exact shape of the reference's K562 10Kb benchmark row
(README.rst:291: pyHICCUPS 1:57:33 wall / <4 GB RSS for the whole
genome, (pw,ww)=(2,5)).

Writes benchmarks/GENOME_SCALE.json (GENOME_SCALE_multipair.json with
GS_MULTIPAIR=1; both gitignored) and prints one JSON line.

Env knobs: GS_L (bins, default 24900), GS_MULTIPAIR=1 for
pw=(1,2)/ww=(3,5).
"""
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

OUT_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    'GENOME_SCALE_multipair.json'
    if os.environ.get('GS_MULTIPAIR') else 'GENOME_SCALE.json')


def log(msg):
    print(f'[genome-scale] {msg}', file=sys.stderr, flush=True)


def main():
    t_all = time.time()
    from hicpeaks_tpu.cli.common import enable_compilation_cache
    cache_dir = enable_compilation_cache()

    # entries written during the run = actual cold compiles; the
    # warm/cold label is derived from that delta after the fact
    def _cache_files():
        return sum(len(fs) for _, _, fs in os.walk(cache_dir))
    cache_files_before = _cache_files()
    import jax
    from hicpeaks_tpu.core import engine
    from hicpeaks_tpu.core.config import HiccupsConfig
    from hicpeaks_tpu.io.synth import synthesize_chrom
    from hicpeaks_tpu.ops.band import build_bands

    log(f'devices: {jax.devices()}')

    res = 10000
    L = int(os.environ.get('GS_L', 24900))
    maxapart = 10_000_000
    maxww = 10
    if os.environ.get('GS_MULTIPAIR') == '1':
        pw, ww = (1, 2), (3, 5)
    else:
        pw, ww = (2,), (5,)
    num = maxapart // res + maxww + 1          # 1011
    cfg = HiccupsConfig(pw=pw, ww=ww, maxww=maxww, maxapart=maxapart)

    t0 = time.time()
    b1, b2, ct, loops, bias_vec = synthesize_chrom(
        n_bins=L, res=res, seed=42, depth=40.0, n_loops=2000, decay=0.75,
        max_loop_span_bins=num - maxww - 54)   # fills all `num` diagonals
    w = np.full(L, np.nan)
    ok = bias_vec > 0
    w[ok] = 1.0 / bias_vec[ok]
    log(f'synthesized {ct.size} contacts ({ct.sum():.3g} total count) '
        f'in {time.time() - t0:.0f}s')

    t0 = time.time()
    bands = build_bands(b1, b2, ct, w, L, num, min(ww), res,
                        dtype=np.float32, lane_pad=4096)
    t_band = time.time() - t0
    drow = np.arange(bands.raw.shape[0])[:, None]
    n_cand = int(((bands.raw != 0) & (drow >= min(ww)) &
                  (drow <= maxapart // res)).sum())
    log(f'bands {bands.raw.shape} built in {t_band:.0f}s; '
        f'{n_cand} candidate pixels')

    # stage the slab+vector transfers up front, exactly like the api.py
    # prefetch thread does in a genome run (the transfer overlaps the
    # previous chromosome's compute there); timed separately so the
    # steady number is the per-chromosome device pipeline cost
    t0 = time.time()
    engine.stage_chrom_arrays(bands)
    jax.block_until_ready(jax.tree_util.tree_leaves(bands._staged))
    t_transfer = time.time() - t0
    log(f'slab+vector staging (prefetch-overlapped in production): '
        f'{t_transfer:.1f}s')

    def run():
        return engine.hiccups_chrom(bands, cfg)

    t0 = time.time()
    table = run()
    t_first = time.time() - t0
    log(f'first call (compile+run): {t_first:.1f}s, {len(table)} peaks')

    t0 = time.time()
    table2 = run()
    t_steady = time.time() - t0
    log(f'second call (steady): {t_steady:.1f}s, {len(table2)} peaks')

    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    stats = jax.devices()[0].memory_stats() or {}
    dev = jax.devices()[0]

    pixels_per_s = n_cand / t_steady
    # reference full-genome K562 10Kb: 139.9M raw contacts in 7053 s
    ref_pixels_per_s = 139_884_876 / 7053.0
    result = {
        'config': {'L': L, 'res': res, 'maxapart': maxapart, 'num': num,
                   'pw': list(pw), 'ww': list(ww), 'maxww': maxww,
                   'contacts': int(ct.size)},
        'device': {'platform': dev.platform, 'kind': dev.device_kind,
                   'count': len(jax.devices())},
        'candidates': n_cand,
        'band_build_s': round(t_band, 1),
        'transfer_s': round(t_transfer, 1),
        'compile_cache': ('warm' if _cache_files() == cache_files_before
                          else 'cold'),
        'cache_entries_written': _cache_files() - cache_files_before,
        'first_call_s': round(t_first, 1),
        'steady_call_s': round(t_steady, 1),
        'pixels_per_s': round(pixels_per_s, 1),
        'vs_reference_rate': round(pixels_per_s / ref_pixels_per_s, 1),
        'peaks': len(table2),
        'peak_rss_gb': round(rss_gb, 2),
        'peak_device_bytes': stats.get('peak_bytes_in_use'),
        'total_wall_s': round(time.time() - t_all, 1),
        'parity_runs_identical': table == table2,
    }
    with open(OUT_PATH, 'w') as f:
        json.dump(result, f, indent=1)
    print(json.dumps({'metric': 'genome-scale hiccups pixels/s',
                      'value': result['pixels_per_s'],
                      'unit': 'pixels/s',
                      'vs_baseline': result['vs_reference_rate']}),
          flush=True)


if __name__ == '__main__':
    main()
