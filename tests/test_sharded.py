"""Multi-device parity: the halo-exchange sharded scan on the 8 virtual CPU
devices must reproduce the single-device engine's peak tables exactly."""
import jax
import numpy as np
import pytest

from hicpeaks_tpu.io.synth import synthetic_cooler
from hicpeaks_tpu.io.coolerlite import CoolerLite
from hicpeaks_tpu.core.config import BHFDRConfig, HiccupsConfig
from hicpeaks_tpu.core import engine
from hicpeaks_tpu.ops.band import bands_from_cooler
from hicpeaks_tpu.parallel.mesh import make_tile_mesh


@pytest.fixture(scope='module')
def synth(tmp_path_factory):
    path = tmp_path_factory.mktemp('data') / 'shard.cool'
    uri, loops = synthetic_cooler(str(path), n_bins=384, res=25000, seed=7,
                                  n_loops=25, depth=60.0)
    return CoolerLite(uri), loops


def test_eight_virtual_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_bhfdr_matches_single_device(synth):
    clr, _ = synth
    cfg = BHFDRConfig(pw=1, ww=3, maxww=8, maxapart=2000000)
    bands = bands_from_cooler(clr, '21', cfg.maxapart, cfg.maxww, cfg.ww,
                              dtype=np.float64)
    single = engine.bhfdr_chrom(bands, cfg)
    mesh = make_tile_mesh(8)
    sharded = engine.bhfdr_chrom(bands, cfg, mesh=mesh)
    assert single == sharded


def test_sharded_hiccups_matches_single_device(synth):
    clr, _ = synth
    cfg = HiccupsConfig(pw=(1, 2), ww=(3, 5), maxww=8, maxapart=2000000,
                        min_marginal_peaks=2, min_local_reads=16)
    bands = bands_from_cooler(clr, '21', cfg.maxapart, cfg.maxww, 3,
                              dtype=np.float64)
    single = engine.hiccups_chrom(bands, cfg)
    mesh = make_tile_mesh(8)
    sharded = engine.hiccups_chrom(bands, cfg, mesh=mesh)
    assert set(single) == set(sharded)
    for k in single:
        np.testing.assert_allclose(np.asarray(single[k], float),
                                   np.asarray(sharded[k], float), rtol=1e-12)


def test_ir_sharded_matches_host_builder(synth):
    """parallel/tiles.ir_sharded (psum'd NaN-aware diagonal means from the
    tile-sharded slab) equals ops/band.build_bands' controller IR exactly
    in f64 — including the zero-weight-stays-in-denominator rule and the
    ww_min/num row zeroing."""
    import jax.numpy as jnp
    from hicpeaks_tpu.parallel.tiles import ir_sharded, shard_band

    clr, _ = synth
    bands = bands_from_cooler(clr, '21', 2000000, 8, 3, dtype=np.float64)
    assert bands.nanw is not None and bands.nanw.any()
    mesh = make_tile_mesh(8)
    raw_sh = shard_band(jnp.asarray(bands.raw), mesh)
    ir_dev = np.asarray(ir_sharded(raw_sh, jnp.asarray(bands.w0),
                                   jnp.asarray(bands.nanw), bands.L,
                                   bands.ww_min, bands.num, mesh))
    host = np.asarray(bands.IR, np.float64)
    # identical finite values; matching nan positions (0/0 diagonals)
    np.testing.assert_allclose(ir_dev, host, rtol=1e-12, equal_nan=True)


def test_sharded_hiccups_device_ir_matches_single_device(synth):
    clr, _ = synth
    cfg = HiccupsConfig(pw=(1, 2), ww=(3, 5), maxww=8, maxapart=2000000,
                        min_marginal_peaks=2, min_local_reads=16)
    bands = bands_from_cooler(clr, '21', cfg.maxapart, cfg.maxww, 3,
                              dtype=np.float64)
    single = engine.hiccups_chrom(bands, cfg)
    mesh = make_tile_mesh(8)
    sharded = engine.hiccups_chrom(bands, cfg, mesh=mesh,
                                   ir_backend='device')
    assert set(single) == set(sharded)
    for k in single:
        np.testing.assert_allclose(np.asarray(single[k], float),
                                   np.asarray(sharded[k], float), rtol=1e-9)


def test_sharded_ingestion_matches_host_loader(synth):
    """parallel.multihost.sharded_bands_from_cooler (per-host column-tile
    reads via the bin1_offset index + small reductions) must reproduce
    the host loader's band content, vectors and candidate totals, and
    feed the mesh engine to identical peak tables."""
    from hicpeaks_tpu.parallel.multihost import sharded_bands_from_cooler

    clr, _ = synth
    cfg = HiccupsConfig(pw=(1,), ww=(3,), maxww=8, maxapart=2000000,
                        min_marginal_peaks=2, min_local_reads=16)
    mesh = make_tile_mesh(8)
    host = bands_from_cooler(clr, '21', cfg.maxapart, cfg.maxww, 3,
                             dtype=np.float64)
    shd = sharded_bands_from_cooler(clr, '21', cfg.maxapart, cfg.maxww, 3,
                                    mesh, dtype=np.float64)

    Lp = host.raw.shape[1]
    raw_global = np.asarray(shd.raw)        # single process: fully local
    np.testing.assert_array_equal(raw_global[:, :Lp], host.raw)
    assert not raw_global[:, Lp:].any()
    np.testing.assert_allclose(shd.IR, host.IR, rtol=0, atol=0)
    np.testing.assert_array_equal(shd.gap[:Lp], host.gap)
    np.testing.assert_allclose(shd.bias[:Lp], host.bias)
    np.testing.assert_allclose(shd.w0[:Lp], host.w0)
    assert shd.candidate_total(3, cfg.maxapart // clr.binsize) == \
        host.candidate_total(3, cfg.maxapart // clr.binsize)
    assert shd.nnz() == host.nnz()

    want = engine.hiccups_chrom(host, cfg, mesh=mesh)
    got = engine.hiccups_chrom(shd, cfg, mesh=mesh)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(np.asarray(want[k], float),
                                   np.asarray(got[k], float), rtol=1e-12)


def test_sharded_hiccups_float32_multipair_matches_single_device(synth):
    """Production dtype (float32 bands), multi-pair config: the 8-device
    halo-exchange run reproduces the single-device tables."""
    clr, _ = synth
    cfg = HiccupsConfig(pw=(1, 2), ww=(3, 5), maxww=8, maxapart=2000000,
                        min_marginal_peaks=2, min_local_reads=16)
    bands = bands_from_cooler(clr, '21', cfg.maxapart, cfg.maxww, 3,
                              dtype=np.float32)
    single = engine.hiccups_chrom(bands, cfg)
    sharded = engine.hiccups_chrom(bands, cfg, mesh=make_tile_mesh(8))
    assert len(single) > 0
    assert set(single) == set(sharded)
    for k in single:
        np.testing.assert_allclose(np.asarray(single[k], float),
                                   np.asarray(sharded[k], float), rtol=1e-12)
