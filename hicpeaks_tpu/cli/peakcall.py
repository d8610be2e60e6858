"""pyHICCUPS / pyBHFDR command-line tools (JAX device engine).

Flag names, defaults, output formats and logging mirror the reference
CLIs exactly (scripts/pyHICCUPS:12-212, scripts/pyBHFDR:12-181) — the
flags are API surface for reproduction scripts.  The per-chromosome
multiprocess fan-out becomes a sequential dispatch of device-resident
chromosome calls (one band tensor at a time on the chip, optionally
sharded across a device mesh with --mesh-devices).
"""
from __future__ import annotations

import argparse
import logging
import sys

from .. import __version__
from .common import (setup_logging, echo_arguments,
                     enable_compilation_cache)


def _common_data_args(parser):
    parser.add_argument('-O', '--output', help='Output file name.')
    group_1 = parser.add_argument_group(title='Relate to Hi-C data:')
    group_1.add_argument('-p', '--path', help='Cooler URI.')
    group_1.add_argument('-C', '--chroms', nargs='*', default=['#', 'X'],
                         help='List of chromosome labels. Only Hi-C data '
                         'within the specified chromosomes will be included. '
                         'Specially, "#" stands for chromosomes with '
                         'numerical labels. "--chroms" with zero argument '
                         'will include all chromosome data.')
    return group_1


def _engine_args(parser):
    g = parser.add_argument_group(title='Device Engine:')
    g.add_argument('--bh-backend', default='auto',
                   choices=['auto', 'host', 'device'],
                   help='Where the Benjamini-Hochberg step runs.')
    g.add_argument('--shape-bucket', type=int, default=4096,
                   help='Pad chromosome band length to a multiple of this so '
                   'compiled programs are shared across chromosomes.')
    g.add_argument('--checkify', action='store_true',
                   help='Run the scoring step under jax checkify '
                   '(NaN/inf/out-of-bounds instrumentation; slower).')
    g.add_argument('--watchdog', type=int, default=0, metavar='SECONDS',
                   help='Abort with a logged error and exit code 3 if the '
                   'run exceeds this many seconds (0 = off).  Uses SIGALRM '
                   'plus a timer-thread backstop, so it fires even while '
                   'the main thread waits inside a device call.')
    return g


def _arm_watchdog(seconds):
    """Returns a disarm callable (a no-op when seconds == 0) — callers
    must disarm on success or the still-armed alarm would kill a host
    process (pytest, notebook) long after the run returned."""
    if not seconds:
        return lambda: None
    import logging
    import os as _os
    import signal
    import threading

    def fire(*_):
        logging.getLogger(__name__).error(
            'watchdog: run exceeded %ds; aborting', seconds)
        _os._exit(3)

    signal.signal(signal.SIGALRM, fire)
    signal.alarm(seconds)
    t = threading.Timer(seconds + 30, fire)
    t.daemon = True
    t.start()

    def disarm():
        signal.alarm(0)
        t.cancel()

    return disarm


def hiccups_main(argv=None):
    parser = argparse.ArgumentParser(
        usage='%(prog)s <-O output> [options]',
        description='A JAX-accelerated implementation of the HiCCUPS '
                    'algorithm.',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('-v', '--version', action='version',
                        version=' '.join(['%(prog)s', __version__]))
    parser.add_argument('--logFile', default='pyHICCUPS.log',
                        help='Logging file name.')
    _common_data_args(parser)
    g = parser.add_argument_group(title='Algorithm Parameters:')
    g.add_argument('--pw', type=int, nargs='+', help='List of the peak widths.')
    g.add_argument('--ww', type=int, nargs='+', help='List of the donut widths.')
    g.add_argument('--maxww', type=int, default=10, help='Maximum donut width.')
    g.add_argument('--siglevel', type=float, default=0.05,
                   help='Significant Level.')
    g.add_argument('--sumq', type=float, default=0.01,
                   help='Sum-of-2-q-values threshold for singleton rescue.')
    g.add_argument('--double-fold', type=float, default=1.75,
                   help='Minimum fold enrichment against both backgrounds.')
    g.add_argument('--single-fold', type=float, default=2,
                   help='Minimum fold enrichment against either background.')
    g.add_argument('--clr-weight-name', default='weight',
                   help='Name of the weight column for normalization.')
    g.add_argument('--use-raw', action='store_true',
                   help='Sort peak pixels by raw signal during clustering.')
    g.add_argument('--min-marginal-peaks', type=int, default=2,
                   help='Minimum marginal number of peaks for anchors.')
    g.add_argument('--min-local-reads', type=int, default=16,
                   help='Minimum local raw-read sum for a valid loop.')
    g.add_argument('--only-anchors', action='store_true',
                   help='Either peak locus must be an anchor.')
    g.add_argument('--maxapart', type=int, default=10000000,
                   help='Maximum genomic distance between two loci.')
    g.add_argument('--nproc', type=int, default=1,
                   help='Accepted for compatibility; the engine '
                   'dispatches chromosomes sequentially on device.')
    g.add_argument('--mesh-devices', type=int, default=0,
                   help='Shard each chromosome band across this many devices '
                   '(0 = single device).')
    g.add_argument('--checkpoint-dir', default=None,
                   help='Persist per-chromosome peak tables here and resume '
                   'finished chromosomes on rerun.')
    _engine_args(parser)
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    if args.output is None:
        parser.print_help()
        return 1

    enable_compilation_cache()
    logger = setup_logging(args.logFile)
    disarm = _arm_watchdog(args.watchdog)
    echo_arguments(logger, [
        ('Output file', args.output), ('Cooler URI', args.path),
        ('Chromosomes', args.chroms), ('Peak window width', args.pw),
        ('Donut width', args.ww), ('Maximum donut width', args.maxww),
        ('Significant Level', args.siglevel), ('Sum of 2 q-values', args.sumq),
        ('Double fold threshold', args.double_fold),
        ('Single fold threshold', args.single_fold),
        ('Weight column name', args.clr_weight_name),
        ('Use Raw IF in clustering', args.use_raw),
        ('Minimum marginal peaks', args.min_marginal_peaks),
        ('Only remain anchors', args.only_anchors),
        ('Maximum Genomic distance', args.maxapart),
        ('Mesh devices', args.mesh_devices)])

    from ..api import call_hiccups
    from ..core.config import HiccupsConfig
    from ..io.coolerlite import CoolerLite
    from ..io.peakfile import write_hiccups_bedpe

    cfg = HiccupsConfig(
        pw=tuple(args.pw), ww=tuple(args.ww), maxww=args.maxww,
        siglevel=args.siglevel, sumq=args.sumq, double_fold=args.double_fold,
        single_fold=args.single_fold, maxapart=args.maxapart,
        use_raw=args.use_raw, min_marginal_peaks=args.min_marginal_peaks,
        min_local_reads=args.min_local_reads, only_anchors=args.only_anchors,
        clr_weight_name=args.clr_weight_name)

    from ..parallel.launch import maybe_initialize_distributed
    maybe_initialize_distributed()
    mesh = None
    if args.mesh_devices:
        from ..parallel.mesh import make_tile_mesh
        mesh = make_tile_mesh(args.mesh_devices)

    logger.info('Loading Hi-C data ...')
    res = CoolerLite(args.path).binsize
    logger.info('Calling Peaks ...')
    results = call_hiccups(args.path, cfg, chroms=args.chroms, mesh=mesh,
                           checkpoint_dir=args.checkpoint_dir,
                           bh_backend=args.bh_backend,
                           shape_bucket=args.shape_bucket,
                           check=args.checkify)
    with open(args.output, 'w') as out:
        for label, table in results.items():
            write_hiccups_bedpe(out, label, res, table)
    logger.info('Done!')
    disarm()
    return 0


def bhfdr_main(argv=None):
    parser = argparse.ArgumentParser(
        usage='%(prog)s <-O output> [options]',
        description='A JAX-accelerated implementation of the BH-FDR '
                    'algorithm.',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('-v', '--version', action='version',
                        version=' '.join(['%(prog)s', __version__]))
    parser.add_argument('--logFile', default='pyBHFDR.log',
                        help='Logging file name.')
    _common_data_args(parser)
    g = parser.add_argument_group(title='Algorithm Parameters:')
    g.add_argument('--pw', type=int, default=2,
                   help='Width of the peak region.')
    g.add_argument('--ww', type=int, default=5, help='Donut width.')
    g.add_argument('--maxww', type=int, default=10, help='Maximum donut width.')
    g.add_argument('--siglevel', type=float, default=0.05,
                   help='Significant Level.')
    g.add_argument('--maxapart', type=int, default=2000000,
                   help='Maximum genomic distance between two loci.')
    g.add_argument('--clr-weight-name', default='weight',
                   help='Name of the weight column for normalization.')
    g.add_argument('--nproc', type=int, default=1,
                   help='Accepted for compatibility.')
    g.add_argument('--mesh-devices', type=int, default=0,
                   help='Shard each chromosome band across this many devices.')
    g.add_argument('--checkpoint-dir', default=None,
                   help='Persist per-chromosome peak tables here and resume '
                   'finished chromosomes on rerun.')
    _engine_args(parser)
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    if args.output is None:
        parser.print_help()
        return 1

    enable_compilation_cache()
    logger = setup_logging(args.logFile, rotating=True)
    disarm = _arm_watchdog(args.watchdog)
    echo_arguments(logger, [
        ('Output file', args.output), ('Cooler URI', args.path),
        ('Chromosomes', args.chroms), ('Peak window width', args.pw),
        ('Donut width', args.ww), ('Maximum donut width', args.maxww),
        ('Significant Level', args.siglevel),
        ('Maximum Genomic distance', args.maxapart),
        ('Weight column name', args.clr_weight_name)])

    from ..api import call_bhfdr
    from ..core.config import BHFDRConfig
    from ..io.coolerlite import CoolerLite
    from ..io.peakfile import write_bhfdr_bedpe

    cfg = BHFDRConfig(pw=args.pw, ww=args.ww, maxww=args.maxww,
                      siglevel=args.siglevel, maxapart=args.maxapart,
                      clr_weight_name=args.clr_weight_name)
    from ..parallel.launch import maybe_initialize_distributed
    maybe_initialize_distributed()
    mesh = None
    if args.mesh_devices:
        from ..parallel.mesh import make_tile_mesh
        mesh = make_tile_mesh(args.mesh_devices)

    logger.info('Loading Hi-C data ...')
    res = CoolerLite(args.path).binsize
    logger.info('Calling Peaks ...')
    results = call_bhfdr(args.path, cfg, chroms=args.chroms, mesh=mesh,
                         checkpoint_dir=args.checkpoint_dir,
                         bh_backend=args.bh_backend,
                         shape_bucket=args.shape_bucket,
                         check=args.checkify)
    with open(args.output, 'w') as out:
        for label, table in results.items():
            write_bhfdr_bedpe(out, label, res, table)
    logger.info('Done!')
    disarm()
    return 0
