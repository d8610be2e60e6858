#!/usr/bin/env python
"""Sharding-overhead curve on 1..8 virtual CPU devices.

A proxy for the cost of sharding that needs no accelerators: the
same chromosome run through the sharded engine (halo ppermute + psum'd
freeze counts + sharded scoring) on meshes of 1, 2, 4 and 8 virtual
devices that all share the same physical cores.  Because total compute
capacity is constant, wall-clock(n) / wall-clock(1) isolates the cost the
sharded program *adds* (collectives, halo duplication, per-shard
padding).  Peak tables must be identical at every n (asserted).

Writes benchmarks/SHARDING_OVERHEAD.json (gitignored).
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ['JAX_PLATFORMS'] = 'cpu'
flags = os.environ.get('XLA_FLAGS', '')
if '--xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + ' --xla_force_host_platform_device_count=8').strip()

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_PATH = os.path.join(HERE, 'SHARDING_OVERHEAD.json')


def log(msg):
    print(f'[sharding-overhead] {msg}', file=sys.stderr, flush=True)


def main():
    import jax
    assert jax.default_backend() == 'cpu'

    from hicpeaks_tpu.core import engine, flagship
    from hicpeaks_tpu.core.config import HiccupsConfig
    from hicpeaks_tpu.parallel.mesh import make_tile_mesh

    L = int(os.environ.get('SO_L', 4096))
    bands = flagship.demo_inputs(L=L, num=128, dtype='float32')
    cfg = HiccupsConfig(pw=(1, 2), ww=(3, 5), maxww=8,
                        maxapart=100 * bands.res, min_marginal_peaks=2,
                        min_local_reads=16)

    results = {}
    baseline_table = None
    base_t = None
    for n in (1, 2, 4, 8):
        mesh = make_tile_mesh(n)
        # warm-up (compile) + two timed steady calls, best-of
        engine.hiccups_chrom(bands, cfg, mesh=mesh)
        ts = []
        for _ in range(2):
            t0 = time.perf_counter()
            table = engine.hiccups_chrom(bands, cfg, mesh=mesh)
            ts.append(time.perf_counter() - t0)
        t = min(ts)
        if baseline_table is None:
            baseline_table, base_t = table, t
        else:
            assert table == baseline_table, f'peak-table mismatch at n={n}'
        results[n] = {'steady_s': round(t, 3),
                      'overhead_vs_1dev': round(t / base_t, 3),
                      'peaks': len(table)}
        log(f'n={n}: {t:.3f}s steady, overhead {t / base_t:.2f}x, '
            f'{len(table)} peaks (identical to n=1: '
            f'{table == baseline_table})')

    out = {
        'config': {'L': L, 'num': 128, 'pw': [1, 2], 'ww': [3, 5],
                   'backend': 'cpu (8 virtual devices, shared cores)'},
        'note': 'constant total compute: overhead_vs_1dev isolates '
                'collective/halo/padding cost added by sharding; peak '
                'tables asserted identical across mesh sizes',
        'results': results,
    }
    with open(OUT_PATH, 'w') as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
