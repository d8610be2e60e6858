"""CLI end-to-end: TXT folders -> toCooler (ingestion + device ICE) ->
pyBHFDR / pyHICCUPS -> combine-resolutions -> apa-analysis / peak-plot,
exercising the full reference workflow (README.rst:119-256) in-process."""
import os

import numpy as np
import pytest

from hicpeaks_tpu.io.synth import synthesize_chrom, write_txt
from hicpeaks_tpu.io.coolerlite import CoolerLite
from hicpeaks_tpu.cli import tocooler, peakcall, combine, apa, peakplot


@pytest.fixture(scope='module')
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp('cli')
    res = 25000
    n_bins = 300
    folder = root / '25K'
    folder.mkdir()
    b1, b2, ct, loops, bias = synthesize_chrom(
        n_bins=n_bins, res=res, seed=5, n_loops=20, depth=80.0)
    write_txt(str(folder / '21_21.txt'), b1, b2, ct)
    with open(root / 'hg38.chromsizes', 'w') as f:
        f.write(f'chr21\t{n_bins * res}\n')
    with open(root / 'datasets', 'w') as f:
        f.write(f'res:{res}\n  ./25K\n'.replace('./25K', str(folder)))
    return dict(root=root, res=res, n_bins=n_bins, loops=loops)


def test_tocooler_ingests_and_balances(workspace):
    root = workspace['root']
    out = root / 'test.cool'
    os.chdir(root)
    rc = tocooler.main(['-O', str(out), '-d', str(root / 'datasets'),
                        '--chromsizes-file', str(root / 'hg38.chromsizes'),
                        '--assembly', 'hg38',
                        '--logFile', str(root / 'tocooler.log')])
    assert rc == 0
    clr = CoolerLite(f'{out}::{workspace["res"]}')
    assert clr.chromnames == ['21']
    w = clr.weights('21')
    assert w.shape == (workspace['n_bins'],)
    assert np.isfinite(w).sum() > workspace['n_bins'] * 0.8
    # balanced marginals of valid bins should be near-uniform
    M = clr.fetch_sparse('21', balance='weight')
    marg = np.asarray(np.nansum(M.toarray(), axis=1))
    valid = np.isfinite(w)
    marg = marg[valid]
    assert marg.std() / marg.mean() < 0.35


def test_peak_callers_and_postprocessing(workspace):
    root = workspace['root']
    res = workspace['res']
    uri = f'{root}/test.cool::{res}'
    os.chdir(root)

    rc = peakcall.bhfdr_main(['-O', str(root / 'bhfdr.bedpe'), '-p', uri,
                              '--pw', '1', '--ww', '3',
                              '--logFile', str(root / 'b.log')])
    assert rc == 0
    lines = open(root / 'bhfdr.bedpe').read().strip().splitlines()
    assert len(lines) > 0
    assert all(len(l.split('\t')) == 13 for l in lines)

    rc = peakcall.hiccups_main(['-O', str(root / 'hiccups.bedpe'), '-p', uri,
                                '--pw', '1', '--ww', '3', '--maxww', '8',
                                '--maxapart', '2000000',
                                '--logFile', str(root / 'h.log')])
    assert rc == 0
    lines = open(root / 'hiccups.bedpe').read().strip().splitlines()
    assert len(lines) > 0
    assert all(len(l.split('\t')) == 16 for l in lines)

    rc = combine.main(['-O', str(root / 'combined.bedpe'),
                       '-p', str(root / 'hiccups.bedpe'),
                       str(root / 'bhfdr.bedpe'),
                       '-R', str(res), str(res * 2),
                       '--max-res', str(res * 2), '-S', '0'])
    assert rc == 0
    lines = open(root / 'combined.bedpe').read().strip().splitlines()
    assert len(lines) > 0
    assert all(len(l.split('\t')) == 6 for l in lines)

    rc = apa.main(['-O', str(root / 'apa.png'), '-p', uri,
                   '-I', str(root / 'hiccups.bedpe'), '-S', '0',
                   '-M', '5'])
    assert rc == 0
    assert (root / 'apa.png').stat().st_size > 0

    rc = peakplot.main(['-O', str(root / 'plot.png'), '-p', uri,
                        '-I', str(root / 'hiccups.bedpe'),
                        '-C', '21', '-S', '0',
                        '-E', str(100 * res), '--skip-rows', '0'])
    assert rc == 0
    assert (root / 'plot.png').stat().st_size > 0


def test_engine_flags_switch_backends(workspace):
    """--bh-backend device / --shape-bucket must be selectable from the
    CLI and leave output unchanged."""
    root = workspace['root']
    res = workspace['res']
    uri = f'{root}/test.cool::{res}'
    os.chdir(root)
    rc = peakcall.hiccups_main(['-O', str(root / 'hiccups_v.bedpe'), '-p', uri,
                                '--pw', '1', '--ww', '3', '--maxww', '8',
                                '--maxapart', '2000000',
                                '--bh-backend', 'device',
                                '--shape-bucket', '512',
                                '--logFile', str(root / 'hv.log')])
    assert rc == 0
    assert (open(root / 'hiccups_v.bedpe').read()
            == open(root / 'hiccups.bedpe').read())


def test_native_fastload_matches_numpy(workspace):
    from hicpeaks_tpu.io import fastload
    path = str(workspace['root'] / '25K' / '21_21.txt')
    b1, b2, ct = fastload.load_txt(path)
    ref = np.loadtxt(path)
    np.testing.assert_array_equal(b1, ref[:, 0].astype(np.int64))
    np.testing.assert_array_equal(b2, ref[:, 1].astype(np.int64))
    np.testing.assert_allclose(ct, ref[:, 2])


def test_bedpe_roundtrip(workspace):
    """Writer output must parse back through the reference's own parser
    semantics (skip=0, chr-prefix strip)."""
    from hicpeaks_tpu.io.peakfile import parse_peakfile
    root = workspace['root']
    for name in ('hiccups.bedpe', 'bhfdr.bedpe', 'combined.bedpe'):
        peaks = parse_peakfile(str(root / name), skip=0)
        assert '21' in peaks and len(peaks['21']) > 0
        for s1, e1, s2, e2 in peaks['21']:
            assert e1 - s1 == workspace['res'] or name == 'combined.bedpe'
            assert s2 >= s1
