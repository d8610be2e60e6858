#!/usr/bin/env python
"""toCooler wall-clock at the reference's published T47D scale.

BASELINE.md rows 1/4/7 are ingestion+balancing wall-clocks (TXT ->
cooler -> ICE).  This harness synthesizes a T47D-40Kb-shaped dataset
(~25.2M contacts over 15 chromosomes, 3-column TXT per chromosome — the
exact input format the reference's table measured, README.rst:273-287)
and runs OUR toCooler CLI end-to-end: native TXT parser
(native/fastload.cpp), symmetrize/sort, coolerlite HDF5 writer, and
per-chromosome ICE balancing.

Reference: toCooler T47D 40Kb = 0:07:55 (475s), <600MB RSS on a
2.6GHz i7 (README.rst:287).  Writes benchmarks/TOCOOLER.json
(gitignored).  Needs h5py (the cooler writer).

Env knobs: TC_CONTACTS (target total, default 25_200_000).  jax runs on
the CPU, where balancing runs anyway.
"""
import json
import os
import resource
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_PATH = os.path.join(HERE, 'TOCOOLER.json')


def log(msg):
    print(f'[tocooler-bench] {msg}', file=sys.stderr, flush=True)


def main():
    os.environ.setdefault('JAX_PLATFORMS', 'cpu')

    sys.path.insert(0, os.path.dirname(HERE))
    from hicpeaks_tpu.io.synth import synthesize_chrom, write_txt

    res = int(os.environ.get('TC_RES', 40000))
    target = int(os.environ.get('TC_CONTACTS', 25_200_000))
    ref_wall = float(os.environ.get('TC_REF_WALL', 475.0))
    ref_row = os.environ.get('TC_REF_ROW',
                             'T47D 40Kb toCooler 0:07:55 <600M '
                             '(README.rst:287)')
    genome_bins = int(os.environ.get('TC_GENOME_BINS', 77_000))
    max_d = int(os.environ.get('TC_MAX_D', 436))
    # hg-like chromosome lengths, scaled to 15 chromosomes
    rel = np.array([249, 243, 198, 191, 181, 171, 159, 146, 141, 136,
                    135, 133, 115, 107, 102], float)
    bins = (rel / rel.sum() * genome_bins).astype(int)

    td = tempfile.mkdtemp(prefix='tocooler_bench_')
    folder = os.path.join(td, '40K')
    os.makedirs(folder)
    t0 = time.time()
    total = 0
    # self-calibrate depth so the nonzero-record count lands on the target:
    # two pilot draws of the largest chromosome, log-linear interpolation
    pilot = {}
    frac = bins[0] / bins.sum()
    for dpt in (100.0, 220.0):
        b1, b2, ct, _, _ = synthesize_chrom(
            n_bins=int(bins[0]), res=res, seed=400, depth=dpt, decay=0.85,
            n_loops=300, max_loop_span_bins=max_d)
        pilot[dpt] = len(ct) / frac
    lo, hi = pilot[100.0], pilot[220.0]
    t = np.clip((target - lo) / max(hi - lo, 1.0), -2.0, 6.0)
    depth = max(1.0, 100.0 + t * 120.0)
    log(f'pilot: depth 100 -> {lo:.3g}, 220 -> {hi:.3g}; using {depth:.0f}')
    for i, n in enumerate(bins):
        b1, b2, ct, _, _ = synthesize_chrom(
            n_bins=int(n), res=res, seed=400 + i, depth=depth,
            decay=0.85, n_loops=300, max_loop_span_bins=max_d)
        write_txt(os.path.join(folder, f'{i + 1}_{i + 1}.txt'), b1, b2, ct)
        total += len(ct)
    with open(os.path.join(td, 'meta'), 'w') as f:
        f.write(f'res:{res}\n{folder}\n')
    with open(os.path.join(td, 'sizes'), 'w') as f:
        for i, n in enumerate(bins):
            f.write(f'chr{i + 1}\t{int(n) * res}\n')
    t_synth = time.time() - t0
    txt_bytes = sum(os.path.getsize(os.path.join(folder, x))
                    for x in os.listdir(folder))
    log(f'synthesized {total} contact records ({txt_bytes / 1e9:.2f}GB TXT) '
        f'in {t_synth:.0f}s')

    # run the CLI in a child so peak RSS covers toCooler alone (the
    # synthesis above would otherwise dominate ru_maxrss)
    import subprocess
    out = os.path.join(td, 'out.cool')
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(HERE)] +
                   ([os.environ['PYTHONPATH']]
                    if os.environ.get('PYTHONPATH') else [])))
    t0 = time.time()
    rc = subprocess.call(
        [sys.executable, '-c',
         'import sys; from hicpeaks_tpu.cli import tocooler; '
         'sys.exit(tocooler.main(sys.argv[1:]))',
         '-O', out, '-d', os.path.join(td, 'meta'),
         '--chromsizes-file', os.path.join(td, 'sizes'),
         '--logFile', os.path.join(td, 'tc.log')], env=env)
    wall = time.time() - t0
    assert rc == 0
    rss_gb = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 1e6

    # balancing really happened: weights present and finite somewhere
    from hicpeaks_tpu.io.coolerlite import CoolerLite
    w = CoolerLite(f'{out}::{res}').weights()
    n_ok = int(np.isfinite(w).sum())
    log(f'toCooler wall {wall:.0f}s, peak RSS {rss_gb:.2f}GB, '
        f'{n_ok}/{len(w)} balanced bins')

    result = {
        'config': {'contacts': int(total), 'res': res,
                   'n_chroms': len(bins), 'genome_bins': int(bins.sum()),
                   'txt_gb': round(txt_bytes / 1e9, 2),
                   'reference_row': ref_row},
        'synth_s': round(t_synth, 1),
        'tocooler_wall_s': round(wall, 1),
        'peak_rss_gb': round(rss_gb, 2),
        'balanced_bins': n_ok,
        'reference_wall_s': ref_wall,
        'vs_reference': round(ref_wall / wall, 2),
    }
    with open(OUT_PATH, 'w') as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == '__main__':
    main()
