"""apa-analysis CLI: Aggregate Peak Analysis with on-device window
gathering (reference scripts/apa-analysis:12-140)."""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import __version__


def locate_peak_bins(clr, chrom, peaks, res, min_dis_bins, balance=False):
    """For each bedpe interval pair, pick the bin pair with the maximal
    contact value (reference scripts/apa-analysis:98-119).  ``balance``
    must match the matrix used for window extraction — the reference ranks
    candidates on the same (by default balanced) matrix it extracts from
    (scripts/apa-analysis:95,98-119); NaN entries never win the argmax
    but the first candidate is taken unconditionally, exactly as there."""
    M = clr.fetch_sparse(chrom, balance=balance)
    n = M.shape[0]
    pos = []
    for p in peaks:
        x, y = p[0], p[2]
        if abs(y - x) < min_dis_bins * res:
            continue
        s_l = range(p[0] // res, int(np.ceil(p[1] / float(res))))
        e_l = range(p[2] // res, int(np.ceil(p[3] / float(res))))
        si = ei = None
        for st in s_l:
            for et in e_l:
                if st < n and et < n:
                    if si is None or M[st, et] > M[si, ei]:
                        si, ei = st, et
        if si is not None:
            pos.append((si, ei) if si < ei else (ei, si))
    return pos


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Perform Aggregate Peak Analysis (APA).',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('-v', '--version', action='version',
                        version=' '.join(['%(prog)s', __version__]))
    parser.add_argument('-O', '--output', help='Output file name.')
    parser.add_argument('--dpi', default=200, type=int,
                        help='Figure resolution in DPI.')
    parser.add_argument('-p', '--path', help='Cooler URI.')
    parser.add_argument('-I', '--loop-file', help='Loop file in bedpe format.')
    parser.add_argument('-S', '--skip-rows', default=0, type=int,
                        help='Leading loop-file lines to skip.')
    parser.add_argument('-M', '--min-dis', default=10, type=int,
                        help='Minimum separation in bins.')
    parser.add_argument('-W', '--window', default=5, type=int,
                        help='APA window width.')
    parser.add_argument('-C', '--corner-size', default=3, type=int,
                        help='Corner size of the APA matrix.')
    parser.add_argument('--clr-weight-name', default='weight',
                        help='Weight column name ("raw" for raw signals).')
    parser.add_argument('--colormap-name', default='traditional',
                        help='Matplotlib colormap name.')
    parser.add_argument('--vmax', type=float,
                        help='Maximum of the colorbar.')
    parser.add_argument('--device', action='store_true',
                        help='Gather and normalize APA windows on the '
                             'accelerator (ops/apa_ops.apa_windows, '
                             'BASELINE config 5) instead of the float64 '
                             'host path; statistics agree to float32 '
                             'tolerance, pixel-exact figure parity needs '
                             'the default host path.')
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    if args.output is None:
        parser.print_help()
        return 1

    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    from matplotlib.colors import LinearSegmentedColormap

    from ..io.coolerlite import CoolerLite
    from ..io.peakfile import parse_peakfile, find_chrom_pre
    from ..ops.apa_ops import apa_analysis

    cmap = LinearSegmentedColormap.from_list(
        'interaction', ['#FFFFFF', '#ff9292', '#ff6767', '#F70000'])
    correct = False if args.clr_weight_name.lower() == 'raw' else \
        args.clr_weight_name

    clr = CoolerLite(args.path)
    res = clr.binsize
    pre = find_chrom_pre(clr.chromnames)
    peaks = parse_peakfile(args.loop_file, args.skip_rows)

    stacks = []
    for c in peaks:
        chrom = pre + c
        if chrom not in clr.chromsizes:
            continue
        pos = locate_peak_bins(clr, chrom, peaks[c], res, args.min_dis,
                               balance=correct)
        if not pos:
            continue
        # symmetric matrix as an upper band covering every needed diagonal
        b1, b2, ct = clr.pixels_for_chrom(chrom)
        lo, hi = clr.bin_range(chrom)
        L = hi - lo
        d = b2 - b1
        num = int(d.max()) + args.window + 2 if d.size else args.window + 2
        band = np.zeros((num, L))
        vals = ct.astype(np.float64)
        nanvals = np.zeros_like(vals)
        if correct:
            w = clr.weights(chrom, correct)
            scaled = vals * w[b1] * w[b2]
            nanvals = np.isnan(scaled).astype(np.float64)
            vals = np.where(np.isnan(scaled), 0.0, scaled)
        band[d, b1] = vals
        nanband = np.zeros_like(band)
        nanband[d, b1] = nanvals

        if args.device:
            # batched device gather + normalization (jnp reduction order /
            # f32 on an accelerator: tolerance-level, not pixel-exact,
            # parity)
            import jax.numpy as jnp

            from ..ops.apa_ops import apa_windows
            xs_d = jnp.asarray([p[0] for p in pos], jnp.int32)
            ys_d = jnp.asarray([p[1] for p in pos], jnp.int32)
            norm, ok, _means = apa_windows(jnp.asarray(band),
                                           jnp.asarray(nanband),
                                           xs_d, ys_d, args.window, L)
            stacks.append(np.asarray(norm)[np.asarray(ok)])
            continue

        # float64 numpy window extraction/normalization: the reference's
        # 1/99-percentile trim (apa.py:33-35) compares post-normalization
        # window means that are all ~1.0, so which windows it keeps is
        # decided at the last ulp — pixel parity with scripts/apa-analysis
        # therefore needs bit-identical f64 math here (the device path,
        # ops/apa_ops.apa_windows, routes there via --device)
        ww = args.window
        xs = np.asarray([p[0] for p in pos])[:, None, None]
        ys = np.asarray([p[1] for p in pos])[:, None, None]
        off = np.arange(-ww, ww + 1)
        a = xs + off[None, :, None]
        b = ys + off[None, None, :]
        dd = np.abs(b - a)
        xx = np.minimum(a, b)
        valid = (a >= 0) & (b >= 0) & (xx < L) & (dd < num)
        wins = np.where(valid, band[np.clip(dd, 0, num - 1),
                                    np.clip(xx, 0, L - 1)], 0.0)
        nanwins = np.where(valid, nanband[np.clip(dd, 0, num - 1),
                                          np.clip(xx, 0, L - 1)], 0.0)
        inside = ((xs[:, 0, 0] - ww >= 0) & (ys[:, 0, 0] - ww >= 0) &
                  (xs[:, 0, 0] + ww + 1 <= L) & (ys[:, 0, 0] + ww + 1 <= L))
        means = wins.mean(axis=(1, 2))
        ok = inside & (nanwins.sum(axis=(1, 2)) == 0) & (means != 0)
        norm = wins[ok] / means[ok][:, None, None]
        stacks.append(norm)

    apa = np.concatenate(stacks, axis=0) if stacks else np.zeros(
        (0, 2 * args.window + 1, 2 * args.window + 1))
    print(len(apa))
    avg, score, z, p, maxi = apa_analysis(apa, w=args.window,
                                          cw=args.corner_size)
    vmax = maxi if args.vmax is None else args.vmax
    if args.colormap_name == 'traditional':
        plt.imshow(avg, cmap=cmap, vmax=vmax, interpolation='none')
    else:
        plt.imshow(avg, cmap=args.colormap_name, vmax=vmax,
                   interpolation='none')
    plt.tick_params(axis='both', bottom=False, top=False, left=False,
                    right=False, labelbottom=False, labeltop=False,
                    labelleft=False, labelright=False)
    plt.colorbar()
    plt.savefig(args.output, dpi=args.dpi, bbox_inches='tight')
    plt.close()
    return 0
