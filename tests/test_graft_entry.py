"""The driver hooks must always import, compile and run: entry() is the
single-chip flagship step; dryrun_multichip exercises the sharded path."""
import os
import sys

import jax

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_compiles_and_runs():
    sys.path.insert(0, _ROOT)
    import __graft_entry__ as g
    fn, args = g.entry()
    out = fn(*args)
    jax.block_until_ready(out)
    counts, results = out
    assert counts.shape[0] > 0
    assert (1, 3) in results and (2, 5) in results
    for pair_out in results.values():
        assert set(pair_out) == {'K', 'Y'}


def test_dryrun_multichip_small():
    sys.path.insert(0, _ROOT)
    import __graft_entry__ as g
    g.dryrun_multichip(2)
