#!/usr/bin/env python
"""Per-stage wall-clock breakdown of the hiccups pipeline on the device.

Mirrors engine.hiccups_chrom's multi-dispatch path stage by stage at the
reference's default genome-scale config (L=24900 @10Kb, maxapart=10Mb ->
num=1011); each stage ends in ``jax.block_until_ready``.

Two rounds: round 0 = compile+run, round 1 = steady state.  SP_TRACE=1
also writes a jax.profiler trace of the steady round to
benchmarks/stage_trace/.

Writes benchmarks/STAGE_PROFILE.json (gitignored) and prints it.

Env knobs: SP_L (default 24900), SP_TRACE=1.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_PATH = os.path.join(HERE, 'STAGE_PROFILE.json')


def log(msg):
    print(f'[stage-profile] {msg}', file=sys.stderr, flush=True)


def main():
    import jax
    from hicpeaks_tpu.cli.common import enable_compilation_cache
    enable_compilation_cache()
    import jax.numpy as jnp
    from hicpeaks_tpu.core import engine, poolplan
    from hicpeaks_tpu.core.config import HiccupsConfig
    from hicpeaks_tpu.core.clustering import local_clustering
    from hicpeaks_tpu.io.synth import synthesize_chrom
    from hicpeaks_tpu.ops.band import build_bands

    log(f'devices: {jax.devices()}')

    res, maxww, maxapart = 10000, 10, 10_000_000
    L = int(os.environ.get('SP_L', 24900))
    num = maxapart // res + maxww + 1
    pw, ww = (2,), (5,)
    cfg = HiccupsConfig(pw=pw, ww=ww, maxww=maxww, maxapart=maxapart)

    t0 = time.time()
    b1, b2, ct, _, bias_vec = synthesize_chrom(
        n_bins=L, res=res, seed=42, depth=40.0, n_loops=2000, decay=0.75,
        max_loop_span_bins=num - maxww - 54)
    w = np.full(L, np.nan)
    ok = bias_vec > 0
    w[ok] = 1.0 / bias_vec[ok]
    log(f'synth {ct.size} contacts in {time.time() - t0:.0f}s')

    rounds = []
    trace_dir = None

    for rnd in range(2):
        stages = {}

        def stage(name, fn):
            t0 = time.time()
            out = jax.block_until_ready(fn())
            stages[name] = round(time.time() - t0, 3)
            log(f'  r{rnd} {name}: {stages[name]}s')
            return out

        do_trace = rnd == 1 and os.environ.get('SP_TRACE') == '1'
        if do_trace:
            trace_dir = os.path.join(HERE, 'stage_trace')
            jax.profiler.start_trace(trace_dir)

        bands = stage('band_build_host', lambda: build_bands(
            b1, b2, ct, w, L, num, min(ww), res,
            dtype=np.float32, lane_pad=4096, keep_sparse=False))
        raw, cband, eband, IR, Bprod, gap_drop, cand = stage(
            'to_device_sheets', lambda: engine._prep_chrom(
                bands, min(ww), maxapart // res, min(ww)))

        plan = tuple(poolplan.hiccups_pool_plan(pw, ww, maxww))
        p_list = tuple(sorted(set(pw)))
        total = bands.candidate_total(min(ww), maxapart // res)

        counts = stage('pass_a', lambda: engine._count_pass(
            raw, cand, plan, p_list, cfg.min_local_reads, None))
        decision = stage('freeze_replay_host', lambda: (
            poolplan.emulate_freeze_hiccups(plan, np.asarray(counts),
                                            total, ww)))
        allowed = jnp.asarray(decision.allowed)
        outs = stage('pass_b', lambda: engine._capture_pass(
            raw, cband, eband, cand, allowed, plan, p_list,
            cfg.min_local_reads, None))

        max_count = bands.max_count
        if max_count is None:
            max_count = float(bands.raw.max())

        KS, KE, YS, YE = outs[pw[0]]
        pair = stage('score_pair', lambda: engine._score_pair(
            raw, cband, IR, Bprod, KS, KE, YS, YE, ww[0], cand, L,
            cfg.siglevel, gap_drop, max_count=max_count))
        if pair is not None:
            rK, rY = pair
        else:
            rK = stage('score_K', lambda: engine._score_one(
                raw, cband, IR, Bprod, KS, KE, ww[0], cand, L, cfg.siglevel,
                gap_drop, chunked=True, max_count=max_count))
            rY = stage('score_Y', lambda: engine._score_one(
                raw, cband, IR, Bprod, YS, YE, ww[0], cand, L, cfg.siglevel,
                gap_drop, chunked=True, max_count=max_count))

        def combine_and_cluster():
            first = rK['ICE']
            preD = {(int(x), int(y)): (fi, o, f, p, q) for x, y, fi, o, f,
                    p, q in zip(rK['x'], rK['y'], first, rK['O'],
                                rK['Fold'], rK['p'], rK['q'])}
            preL = {(int(x), int(y)): (i, o, f, p, q) for x, y, i, o, f,
                    p, q in zip(rY['x'], rY['y'], rY['ICE'], rY['O'],
                                rY['Fold'], rY['p'], rY['q'])}
            common = set(preD) & set(preL)
            Donuts = {k: preD[k][:5] for k in common}
            LL = {k: preL[k][:5] for k in common}
            return local_clustering(Donuts, LL, res, min_count=3,
                                    r=2 * res, sumq=cfg.sumq)
        stage('combine_cluster_host', combine_and_cluster)

        if do_trace:
            jax.profiler.stop_trace()
            log(f'trace written to {trace_dir}')

        stages['TOTAL'] = round(sum(v for k, v in stages.items()
                                    if k != 'TOTAL'), 2)
        rounds.append(stages)

    stats = jax.devices()[0].memory_stats() or {}
    dev = jax.devices()[0]
    result = {
        'device': {'platform': dev.platform, 'kind': dev.device_kind,
                   'count': len(jax.devices())},
        'config': {'L': L, 'res': res, 'maxapart': maxapart, 'num': num,
                   'pw': list(pw), 'ww': list(ww)},
        'compile_round': rounds[0],
        'steady_round': rounds[1],
        'peak_device_bytes': stats.get('peak_bytes_in_use'),
        'trace_dir': trace_dir,
    }
    with open(OUT_PATH, 'w') as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == '__main__':
    main()
