"""hicpeaks-tpu: an accelerator-resident Hi-C loop-calling engine on JAX.

A from-scratch JAX/XLA re-design of the capabilities of
XiaoTaoWang/HiCPeaks (reference layout: hicpeaks/callers.py,
hicpeaks/utilities.py, hicpeaks/apa.py and six CLI scripts).

Architecture (device-first, not a port):
  * Contact matrices live as dense *diagonal-band tensors* ``[num_diags, L]``
    in device memory instead of scipy sparse matrices.
  * The HiCCUPS donut / lower-left background expectations
    (reference ``callers.py:44-362``) are computed by a vectorized
    widening scan of separable region sums (shift+add stencils that XLA
    fuses) instead of O(w^2) sparse shifted-diagonal accumulation.
  * Poisson survival p-values, lambda-chunking and Benjamini-Hochberg
    run on device; greedy clustering of the (small) candidate set runs
    on the controller in NumPy.
  * Scaling is SPMD over a ``jax.sharding.Mesh``: chromosome band tiles
    with ``maxww`` halos (the stencil analogue of sequence parallelism),
    ``psum`` for ICE marginals / distance-expected means, ``all_gather``
    for candidate-peak merge.
"""

__author__ = 'hicpeaks-tpu developers'
__version__ = '0.1.0'
__license__ = 'GPLv3+'

def __getattr__(name):
    """Lazy public API: hicpeaks_tpu.call_hiccups / call_bhfdr / balance."""
    if name in ('call_hiccups', 'call_bhfdr'):
        from . import api
        return getattr(api, name)
    if name == 'balance':
        from .ops.ice import balance
        return balance
    if name == 'CoolerLite':
        from .io.coolerlite import CoolerLite
        return CoolerLite
    raise AttributeError(name)
