#!/usr/bin/env python
"""Smoke run of the peak callers on one NVIDIA GPU, in one process.

Phases:

1. ingest — a K562-10Kb-density TXT set (hg38 chr1: 24,896 bins,
   ~11.2M pixels; chr21: 4,671 bins, ~2.0M pixels; every diagonal out to
   the 10 Mb search span populated) is synthesized from a seed, parsed
   with the native parser, normalized like toCooler (duplicates summed,
   upper triangle) and ICE-balanced per chromosome.
2. call — pyHICCUPS and pyBHFDR at their CLI defaults on both
   chromosomes, each chromosome through engine.hiccups_chrom /
   engine.bhfdr_chrom (the per-chromosome programs api.call_hiccups runs)
   on bands built by ops/band.build_bands, bedpe written as the CLIs
   write it.  The card's host has no h5py, so the cooler write and read
   of toCooler and the CLIs are left out: the bands are built from the
   parsed pixels in memory.
3. parity — the production engine (exact mode) at the bench shape
   (L 8192 at 10 Kb, 2 Mb span, maxww 10, seed 0), pw 2 / ww 5 and
   pw 1 2 / ww 3 5, against the float64 oracle: identical loci and
   geometry, statistics within 1e-8 relative.
4. kernels — pass A and pass B alone at the chr1 default shape (compile
   seconds, steady milliseconds); pass A / pass B at the bench shape
   against the CPU backend; the (chunk, count) histogram at both shapes
   against np.bincount; then the ``gpu``-marked tests.

``--multi`` runs only the four-card path: chr1 pyHICCUPS at the CLI
defaults on make_tile_mesh(4) against the same chromosome on one card;
the two tables must be identical.

Every line before the last names what it measured.  The last line of
stdout is ``{"ok": true, "device": {...}}``; a failure in any phase, or
any error logged by the engine, exits non-zero without it.  Exits
non-zero when JAX finds no GPU.
"""
import argparse
import json
import logging
import os
import sys
import tempfile
import time

import numpy as np

from bench import (bench_bands, card_line, device_info, fused_plan,
                   oracle_parity, require_gpu)

RES = 10000
#: hg38 chr1 / chr21 at 10 Kb (248,956,422 / 46,709,983 bp)
CHROMS = {'1': 24896, '21': 4671}
#: synthetic depth giving the K562-10Kb pixel density (139.9M pixels
#: over hg38, BASELINE.md): ~11.2M pixels on chr1
DEPTH = 52.0


def log(msg):
    print(f'[smoke] {msg}', flush=True)


class _ErrorCounter(logging.Handler):
    """Counts ERROR records of the package's loggers: a retried
    chromosome attempt still fails the smoke run."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records = []

    def emit(self, record):
        self.records.append(record.getMessage())


def synth_pixels(label, L, tmp):
    """Phase 1 for one chromosome: synthesize, write TXT, parse natively,
    normalize, balance.  Returns (bin1, bin2, count, weights)."""
    from hicpeaks_tpu.io.fastload import load_txt
    from hicpeaks_tpu.io.ingest import _symmetrize_upper
    from hicpeaks_tpu.io.synth import synthesize_chrom, write_txt
    from hicpeaks_tpu.ops.ice import balance_chrom_pixels

    t0 = time.perf_counter()
    b1, b2, ct, _, _ = synthesize_chrom(
        n_bins=L, res=RES, seed=int(label), depth=DEPTH, n_loops=L // 12,
        decay=0.75, max_loop_span_bins=960)
    path = os.path.join(tmp, f'{label}_{label}.txt')
    write_txt(path, b1, b2, ct)
    t_synth = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, y, v = load_txt(path)
    x, y, v = _symmetrize_upper(x, y, v, int(max(x.max(), y.max())) + 1)
    t_parse = time.perf_counter() - t0
    t0 = time.perf_counter()
    w, converged = balance_chrom_pixels(x, y, v, L)
    t_ice = time.perf_counter() - t0
    # like toCooler, a run that hits the iteration limit keeps its weights
    log(f'ingest chr{label}: {L} bins, {x.size} pixels, '
        f'{int((y - x).max()) + 1} diagonals; synth+TXT {t_synth:.1f}s, '
        f'native parse+normalize {t_parse:.1f}s, ICE {t_ice:.1f}s '
        f'(converged {converged}, {int(np.isnan(w).sum())} bins filtered)')
    return x, y, v, w


def chrom_bands(pixels, L, cfg, label):
    """The bands api.call_* builds for one chromosome (CLI default
    --shape-bucket 4096), with the host->device transfer issued."""
    from hicpeaks_tpu.core import engine
    from hicpeaks_tpu.ops.band import build_bands
    x, y, v, w = pixels
    num = cfg.maxapart // RES + cfg.maxww + 1
    bands = build_bands(x, y, v, w, L, num, cfg.ww_min, RES, chrom=label,
                        dtype=np.float32, lane_pad=4096, keep_sparse=False)
    engine.stage_chrom_arrays(bands)
    return bands


def fused_memory(bands, cfg):
    """Compile the production hiccups program for these bands; log its
    compile seconds and compiled memory analysis."""
    from hicpeaks_tpu.core import engine
    plan, total, o_cap = fused_plan(bands, cfg)
    t0 = time.perf_counter()
    compiled = engine.fused_hiccups_launch(bands, cfg, plan, total, o_cap,
                                           lower=True).compile()
    log(f'fused hiccups program chr{bands.chrom} {bands.raw.shape}: '
        f'compile {time.perf_counter() - t0:.1f}s; '
        f'memory_analysis {compiled.memory_analysis()}')


def call_phase(pixels, tmp):
    """Phase 2: both callers on both chromosomes, bedpe written."""
    import jax
    from hicpeaks_tpu.core import engine
    from hicpeaks_tpu.core.config import BHFDRConfig, HiccupsConfig
    from hicpeaks_tpu.io.peakfile import write_bhfdr_bedpe, write_hiccups_bedpe

    for name, cfg, caller, writer in (
            ('pyHICCUPS', HiccupsConfig(), engine.hiccups_chrom,
             write_hiccups_bedpe),
            ('pyBHFDR', BHFDRConfig(), engine.bhfdr_chrom,
             write_bhfdr_bedpe)):
        bedpe = os.path.join(tmp, f'{name}.bedpe')
        with open(bedpe, 'w') as out:
            for label, L in CHROMS.items():
                t0 = time.perf_counter()
                bands = chrom_bands(pixels[label], L, cfg, label)
                t_band = time.perf_counter() - t0
                if name == 'pyHICCUPS' and label == '1':
                    fused_memory(bands, cfg)
                t0 = time.perf_counter()
                table = caller(bands, cfg)
                t_first = time.perf_counter() - t0
                t0 = time.perf_counter()
                again = caller(bands, cfg)
                t_steady = time.perf_counter() - t0
                if again != table:
                    raise RuntimeError(f'{name} chr{label}: a second run '
                                       'gave a different table')
                if not table:
                    raise RuntimeError(f'{name} chr{label}: no peaks')
                writer(out, label, RES, table)
                log(f'{name} chr{label} (pw {cfg.pw}, ww {cfg.ww}, maxww '
                    f'{cfg.maxww}, maxapart {cfg.maxapart}, bands '
                    f'{bands.raw.shape}): {len(table)} peaks; '
                    f'band build {t_band:.2f}s, first call {t_first:.1f}s '
                    f'(compile + run), steady call {t_steady:.3f}s')
        with open(bedpe) as f:
            lines = f.read().splitlines()
        log(f'{name} bedpe: {len(lines)} lines; first: {lines[0]}')
    log(f'peak device bytes after calls: '
        f'{jax.devices()[0].memory_stats()["peak_bytes_in_use"]}')


def parity_phase():
    """Phase 3: production engine vs the float64 oracle, two configs."""
    from hicpeaks_tpu.core.config import HiccupsConfig
    for pw, ww in (((2,), (5,)), ((1, 2), (3, 5))):
        cfg = HiccupsConfig(pw=pw, ww=ww, maxww=10, maxapart=2_000_000)
        bands, w, bias = bench_bands(ww_min=min(ww))
        r = oracle_parity(bands, w, bias, cfg)
        log(f'parity pw={pw} ww={ww} L=8192 (engine vs float64 oracle): {r}')
        if not r['ok']:
            raise RuntimeError(f'parity failed for pw={pw} ww={ww}')


def _timed(fn, *args, n=10):
    """(first-call seconds, median steady seconds, output); every call
    ends in block_until_ready."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    steady = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        steady.append(time.perf_counter() - t0)
    return first, float(np.median(steady)), out


def sheets(bands, cfg):
    """Device sheets and scan plan of a chromosome, as the fused program
    derives them."""
    import jax.numpy as jnp
    from hicpeaks_tpu.core import poolplan
    from hicpeaks_tpu.ops import score as score_ops
    raw, cband, eband, _, _, cand = score_ops.build_sheets_device(
        *(jnp.asarray(a) for a in (bands.raw, bands.w0, bands.bias,
                                   bands.IR, bands.gap)),
        min(cfg.ww), bands.L, min(cfg.ww), cfg.maxapart // RES, min(cfg.ww))
    plan = tuple(poolplan.hiccups_pool_plan(cfg.pw, cfg.ww, cfg.maxww))
    return (raw, cband, eband, cand), plan, tuple(sorted(set(cfg.pw)))


def time_passes(bands, cfg):
    """Pass A and pass B alone: compile seconds and steady milliseconds."""
    import jax.numpy as jnp
    from hicpeaks_tpu.ops import scan as scan_ops
    (raw, cband, eband, cand), plan, p_list = sheets(bands, cfg)
    allowed = jnp.ones(len(plan), bool)
    out = {}
    for name, fn, args in (
            ('pass_a', scan_ops.scan_pass_a, (raw, cand)),
            ('pass_b', scan_ops.scan_pass_b,
             (raw, cband, eband, cand, allowed))):
        t0 = time.perf_counter()
        compiled = fn.lower(*args, plan, p_list,
                            cfg.min_local_reads).compile()
        t_compile = time.perf_counter() - t0
        _, steady, _ = _timed(compiled, *args)
        out[name] = {'compile_s': t_compile, 'steady_ms': steady * 1e3}
    return out


def scan_vs_cpu(bands, cfg):
    """Pass A counts and pass B captures on the GPU against the CPU
    backend on the same sheets.  Returns (pass A equal, largest pass B
    difference in float32 ulps)."""
    import jax
    from hicpeaks_tpu.ops import scan as scan_ops
    (raw, cband, eband, cand), plan, p_list = sheets(bands, cfg)
    allowed = np.ones(len(plan), bool)
    cpu = jax.devices('cpu')[0]
    thr = cfg.min_local_reads
    got_a = np.asarray(scan_ops.scan_pass_a(raw, cand, plan, p_list, thr))
    got_b = scan_ops.scan_pass_b(raw, cband, eband, cand, allowed, plan,
                                 p_list, thr)[2]
    host = [jax.device_put(np.asarray(a), cpu)
            for a in (raw, cband, eband, cand, allowed)]
    want_a = np.asarray(scan_ops.scan_pass_a(host[0], host[3], plan,
                                             p_list, thr))
    want_b = scan_ops.scan_pass_b(*host, plan, p_list, thr)[2]
    ulps = 0
    for p in p_list:
        for g, c in zip(got_b[p], want_b[p]):
            g = np.asarray(g, np.float32).view(np.int32).astype(np.int64)
            c = np.asarray(c, np.float32).view(np.int32).astype(np.int64)
            ulps = max(ulps, int(np.abs(g - c).max()))
    return bool(np.array_equal(got_a, want_a)), ulps


def hist_check(bands, o_cap=1024, sig=0.05):
    """The (chunk, count) histogram over the bands' real count
    distribution (chunk ids from the counts' lambda chunk, zero counts in
    trash row 0): exact against np.bincount, and its steady time."""
    import jax
    import jax.numpy as jnp
    from hicpeaks_tpu.ops import score as score_ops
    S, C = score_ops.chunk_rows(o_cap, sig), o_cap + 1
    raw = jnp.asarray(bands.raw)
    cid = jnp.clip(jnp.floor(3 * jnp.log2(raw + 0.5)).astype(jnp.int32) + 2,
                   1, S - 1)
    Oc_p, cid_p, _ = jax.jit(score_ops._chunk_pack, static_argnums=(3, 4))(
        raw, cid, raw > 0, S, C)
    hist = jax.jit(score_ops.chunk_hist, static_argnums=(2, 3))
    _, steady, got = _timed(hist, Oc_p, cid_p, S, C)
    key = (np.asarray(cid_p, np.int64) * C + np.asarray(Oc_p, np.int64))
    want = np.bincount(key.ravel(), minlength=S * C).reshape(S, C)
    return bool(np.array_equal(np.asarray(got), want)), steady, Oc_p.size


def kernel_phase(pixels):
    """Phase 4: pass timings, GPU-vs-CPU scan, histogram exactness."""
    from hicpeaks_tpu.core.config import HiccupsConfig
    cfg = HiccupsConfig()
    chr1 = chrom_bands(pixels['1'], CHROMS['1'], cfg, '1')
    log(f'passes alone, chr1 default shape {chr1.raw.shape}: '
        f'{time_passes(chr1, cfg)}')
    bench_cfg = HiccupsConfig(maxapart=2_000_000)
    bench, _, _ = bench_bands()
    log(f'passes alone, bench shape {bench.raw.shape}: '
        f'{time_passes(bench, bench_cfg)}')
    equal_a, ulps_b = scan_vs_cpu(bench, bench_cfg)
    log(f'scan vs CPU backend, bench shape: pass A counts equal {equal_a}, '
        f'pass B largest difference {ulps_b} ulps')
    if not equal_a:
        raise RuntimeError('pass A counts differ from the CPU backend')
    for tag, bands in (('bench', bench), ('chr1', chr1)):
        exact, steady, n = hist_check(bands)
        log(f'chunk histogram (int32 scatter-add), {tag} shape, {n} pixels: '
            f'exact vs np.bincount {exact}, steady {steady * 1e3:.3f} ms')
        if not exact:
            raise RuntimeError(f'chunk histogram inexact at the {tag} shape')
    from tests import test_chip_smoke
    for name in sorted(dir(test_chip_smoke)):
        fn = getattr(test_chip_smoke, name)
        marks = {m.name for m in getattr(fn, 'pytestmark', [])}
        if name.startswith('test_') and 'gpu' in marks:
            fn()
            log(f'gpu test {name}: passed')


def multi_phase(tmp):
    """--multi: chr1 pyHICCUPS on a 4-card tile mesh vs one card."""
    import jax
    from hicpeaks_tpu.core import engine
    from hicpeaks_tpu.core.config import HiccupsConfig
    from hicpeaks_tpu.parallel.mesh import make_tile_mesh
    if len(jax.devices()) < 4:
        raise RuntimeError(f'--multi needs 4 GPUs, found {jax.devices()}')
    cfg = HiccupsConfig()
    pixels = synth_pixels('1', CHROMS['1'], tmp)
    bands = chrom_bands(pixels, CHROMS['1'], cfg, '1')
    mesh = make_tile_mesh(4)
    tables = {}
    for name, kw in (('one card', {}), ('4-card mesh', {'mesh': mesh})):
        for leg in ('first', 'steady'):
            t0 = time.perf_counter()
            tables[name] = engine.hiccups_chrom(bands, cfg, **kw)
            log(f'chr1 pyHICCUPS on {name}: {len(tables[name])} peaks, '
                f'{leg} call {time.perf_counter() - t0:.2f}s')
    one, sharded = tables['one card'], tables['4-card mesh']
    if one != sharded:
        common = set(one) & set(sharded)
        rel = max((float(np.max(np.abs(np.subtract(one[k], sharded[k]))
                                / np.maximum(np.abs(one[k]), 1e-300)))
                   for k in common), default=0.0)
        raise RuntimeError(f'mesh table differs from one card: '
                           f'{len(set(one) ^ set(sharded))} loci differ, '
                           f'max relative difference {rel:.3g} on the '
                           f'{len(common)} common loci')
    log('chr1 pyHICCUPS tables identical on the 4-card mesh and one card')


def result_line(devices):
    """The run's last stdout line."""
    return json.dumps({'ok': True, 'device': device_info(devices)})


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--multi', action='store_true',
                        help='run only the four-card mesh path')
    args = parser.parse_args(argv)
    devices = require_gpu()
    import jax
    import jaxlib
    from hicpeaks_tpu.cli.common import enable_compilation_cache
    from hicpeaks_tpu.io import fastload
    from hicpeaks_tpu.ops import bandnative

    errors = _ErrorCounter()
    logging.getLogger('hicpeaks_tpu').addHandler(errors)
    log(f'card: {card_line()}')
    log(f'jax {jax.__version__}, jaxlib {jaxlib.__version__}, '
        f'devices {devices}')
    log(f'compile cache: {enable_compilation_cache()}')
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as tmp:
        if args.multi:
            multi_phase(tmp)
        else:
            t0 = time.perf_counter()
            pixels = {label: synth_pixels(label, L, tmp)
                      for label, L in CHROMS.items()}
            log(f'phase ingest: {time.perf_counter() - t0:.1f}s')
            t0 = time.perf_counter()
            call_phase(pixels, tmp)
            log(f'phase call: {time.perf_counter() - t0:.1f}s')
            t0 = time.perf_counter()
            parity_phase()
            log(f'phase parity: {time.perf_counter() - t0:.1f}s')
            t0 = time.perf_counter()
            kernel_phase(pixels)
            log(f'phase kernels: {time.perf_counter() - t0:.1f}s')
        log(f'native libraries loaded: fastload '
            f'{fastload._load_library() is not None}, bandbuild '
            f'{bandnative._load_library() is not None}')
    if errors.records:
        raise RuntimeError(f'the engine logged errors: {errors.records[:3]}')
    log(f'total wall {time.perf_counter() - t_all:.1f}s')
    print(result_line(devices), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
