#!/usr/bin/env python
"""BASELINE config 5 on the device: the full multi-resolution pipeline.

One set of synthetic chr21-scale contacts drawn at 5Kb and aggregated to
10Kb/25Kb (hicpeaks_tpu.io.synth.synthesize_chrom_multires — genuinely
consistent matrices, so combine-resolutions sees real cross-resolution
matches), then:

  pyHICCUPS at 5Kb + 10Kb + 25Kb  (api.call_hiccups, production path)
  -> combine-resolutions           (cli/combine.main, 6-col bedpe)
  -> apa-analysis                  (cli/apa.main, on-device windows + PNG)

mirroring the reference's multi-resolution workflow
(scripts/combine-resolutions:51-71, README.rst:233-256).  Records
per-stage wall-clock + peak counts to benchmarks/MULTIRES.json
(gitignored; MULTIRES_coldcache.json for a run that found the compile
cache empty).  Needs h5py (cooler files) and matplotlib (APA plot).

Env knobs: MR_FINE_BINS.
"""
import glob
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_PATH = os.path.join(HERE, 'MULTIRES.json')


def log(msg):
    print(f'[multires] {msg}', file=sys.stderr, flush=True)


def main():
    t_all = time.time()
    import jax
    from hicpeaks_tpu.cli.common import enable_compilation_cache
    cdir = enable_compilation_cache()
    cache_state = 'warm' if glob.glob(os.path.join(cdir, '*')) else 'cold'
    tmp = tempfile.mkdtemp(prefix='multires_')

    from hicpeaks_tpu import api
    from hicpeaks_tpu.cli import apa, combine
    from hicpeaks_tpu.core.config import HiccupsConfig
    from hicpeaks_tpu.io.coolerlite import (CoolerLite, binnify,
                                            create_cooler_file)
    from hicpeaks_tpu.io.peakfile import write_hiccups_bedpe
    from hicpeaks_tpu.io.synth import synthesize_chrom_multires

    log(f'devices: {jax.devices()}')
    fine_bins = int(os.environ.get('MR_FINE_BINS', 9340))  # chr21 @5Kb
    fine_res = 5000
    resolutions = (5000, 10000, 25000)
    chrom = '21'

    t0 = time.time()
    per_res, loops, _ = synthesize_chrom_multires(
        fine_bins, fine_res=fine_res, resolutions=resolutions,
        seed=21, depth=12.0, n_loops=300, decay=0.75,
        loop_strength=6.0, max_loop_span_bins=380)
    path = os.path.join(tmp, 'multires.cool')
    contacts = 0
    cmax = 0
    for res in resolutions:
        b1, b2, ct, n_bins = per_res[res]
        cmax = max(cmax, int(ct.max()) if ct.size else 0)
        create_cooler_file(f'{path}::{res}',
                           binnify({chrom: fine_bins * fine_res}, res),
                           [{'bin1_id': b1, 'bin2_id': b2, 'count': ct}],
                           metadata={'onlyIntra': 'True'})
        # ICE weights: flat (the synthetic biases cancel in aggregation
        # only approximately; flat weights keep the three resolutions on
        # one observed scale, which is all the combiner consumes)
        CoolerLite(f'{path}::{res}').write_weights(np.ones(n_bins))
        contacts += int(ct.sum())
    t_synth = time.time() - t0
    log(f'3-resolution cooler built in {t_synth:.0f}s '
        f'({int(per_res[fine_res][2].sum())} contacts at {fine_res}bp)')

    stages = {}
    bedpes = []
    n_peaks = {}
    # ONE executable set for all three resolutions:
    # d_hi and L are traced operands, so bucketing the band ROWS to the
    # finest resolution's num, the lanes to its Lp, and the o_cap to the
    # global max count makes every per-resolution static signature
    # identical — the 10Kb/25Kb stages reuse the 5Kb-compiled programs
    maxapart = min(10_000_000, fine_bins * fine_res // 2)
    num_max = maxapart // min(resolutions) + 10 + 1
    row_bucket = -(-num_max // 8) * 8
    lane_bucket = -(-fine_bins // 4096) * 4096
    for res in resolutions:
        cfg = HiccupsConfig(pw=(2,), ww=(5,), maxww=10,
                            maxapart=maxapart)
        t0 = time.time()
        tables = api.call_hiccups(f'{path}::{res}', cfg, chroms=['#'],
                                  shape_bucket=lane_bucket,
                                  row_bucket=row_bucket,
                                  max_count_floor=cmax)
        dt = time.time() - t0
        out = os.path.join(tmp, f'multires-{res}.bedpe')
        with open(out, 'w') as fh:
            for label, table in tables.items():
                write_hiccups_bedpe(fh, label, res, table)
        bedpes.append(out)
        n_peaks[res] = sum(len(t) for t in tables.values())
        stages[f'hiccups_{res}_s'] = round(dt, 1)
        log(f'hiccups @{res}: {n_peaks[res]} peaks in {dt:.1f}s')

    t0 = time.time()
    combined_path = os.path.join(tmp, 'multires-combined.bedpe')
    rc = combine.main(['-O', combined_path, '-p', *bedpes,
                       '-R', *[str(r) for r in resolutions],
                       '--max-res', str(max(resolutions)), '-S', '0'])
    assert rc == 0
    stages['combine_s'] = round(time.time() - t0, 2)
    combined = [l for l in open(combined_path) if l.strip()]
    log(f'combined: {len(combined)} peaks in {stages["combine_s"]}s')

    t0 = time.time()
    rc = apa.main(['-O', os.path.join(tmp, 'multires-apa.png'),
                   '-p', f'{path}::10000', '-I', combined_path, '-S', '0',
                   '--skip-rows', '0'])
    assert rc == 0
    stages['apa_s'] = round(time.time() - t0, 1)
    log(f'APA done in {stages["apa_s"]}s')

    result = {
        'compile_cache': cache_state,
        'device': {'platform': jax.devices()[0].platform,
                   'kind': jax.devices()[0].device_kind,
                   'count': len(jax.devices())},
        'config': {'fine_bins': fine_bins, 'resolutions': list(resolutions),
                   'chrom': chrom, 'planted_loops': len(loops),
                   'contacts_fine': int(per_res[fine_res][2].sum())},
        'synth_s': round(t_synth, 1),
        'peaks_per_res': {str(k): v for k, v in n_peaks.items()},
        'combined_peaks': len(combined),
        'stages': stages,
        'total_wall_s': round(time.time() - t_all, 1),
    }
    out_path = OUT_PATH if cache_state == 'warm' else \
        OUT_PATH.replace('.json', '_coldcache.json')
    with open(out_path, 'w') as fh:
        json.dump(result, fh, indent=1)
    log(f'wrote {out_path}')
    print(json.dumps(result))


if __name__ == '__main__':
    main()
