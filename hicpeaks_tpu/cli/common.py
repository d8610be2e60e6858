"""Shared CLI scaffolding: the reference's logging shape (root logger at
level 10, console + [rotating] file handlers, uniform formatter, argument
echo header — scripts/pyHICCUPS:88-130) and chromosome selection."""
from __future__ import annotations

import logging
import logging.handlers
import os
import sys


#: Checkout root: the compile cache lives in ``<checkout>/.jax_cache``
#: unless JAX_COMPILATION_CACHE_DIR names another directory.
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compilation_cache():
    """Persist XLA compilations across runs, so a later run loads the
    chromosome programs instead of compiling them again.  The cache is
    JAX_COMPILATION_CACHE_DIR when that is set, else
    ``<checkout>/.jax_cache``.  Returns the directory."""
    import jax
    cache = os.environ.get('JAX_COMPILATION_CACHE_DIR') or os.path.join(
        _CHECKOUT, '.jax_cache')
    os.makedirs(cache, exist_ok=True)
    jax.config.update('jax_compilation_cache_dir', cache)
    # cache every program, however fast it compiled
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.0)
    jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0)
    return cache


def setup_logging(log_file, rotating=False, name_width=21):
    logger = logging.getLogger()
    logger.setLevel(10)
    for h in list(logger.handlers):   # idempotent across in-process calls
        logger.removeHandler(h)
        h.close()
    console = logging.StreamHandler()
    if rotating:
        filehandler = logging.handlers.RotatingFileHandler(
            log_file, maxBytes=200000, backupCount=5)
    else:
        filehandler = logging.FileHandler(log_file)
    console.setLevel('INFO')
    filehandler.setLevel('INFO')
    formatter = logging.Formatter(
        fmt=f'%(name)-{name_width}s %(levelname)-7s @ %(asctime)s: %(message)s',
        datefmt='%m/%d/%y %H:%M:%S')
    console.setFormatter(formatter)
    filehandler.setFormatter(formatter)
    logger.addHandler(console)
    logger.addHandler(filehandler)
    logger.info('Python Version: %s', sys.version.split()[0])
    return logger


def echo_arguments(logger, pairs):
    lines = ['# ARGUMENT LIST:'] + [f'# {k} = {v}' for k, v in pairs]
    logger.info('\n' + '\n'.join(lines))


def chrom_selected(label, chroms):
    label = label.lstrip('chr')
    return (not chroms) or (label.isdigit() and '#' in chroms) or \
        (label in chroms)
