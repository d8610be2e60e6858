"""Test harness configuration.

Tests run on CPU with 8 virtual XLA devices (the standard way to exercise
shard_map collectives without several accelerators) and with x64 enabled
so device results can be compared tightly against the float64 oracle.
Tests that need a GPU carry the ``gpu`` marker and skip here; chip_smoke.py
runs them on the card.
"""
import os

os.environ['JAX_PLATFORMS'] = 'cpu'
flags = os.environ.get('XLA_FLAGS', '')
if '--xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (flags + ' --xla_force_host_platform_device_count=8').strip()

import jax  # noqa: E402

jax.config.update('jax_enable_x64', True)

# Persist XLA:CPU compilations across test runs: the engines compile one
# fused program per (shape bucket, config), and the suite exercises many
# configs — cold compiles dominate suite wall time.  Keyed on HLO hash,
# so staleness is not a concern; delete the directory to reset.
_cache = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), '.jax_cache_tests')
# HICPEAKS_TEST_NO_CACHE=1 disables the persistent cache (the jaxlib
# cache serializer segfaults deep into single-process full-suite runs —
# see the fuzz-test isolation note in tests/test_reference_parity.py)
if os.environ.get('HICPEAKS_TEST_NO_CACHE') != '1':
    os.makedirs(_cache, exist_ok=True)
    jax.config.update('jax_compilation_cache_dir', _cache)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.5)

import pytest  # noqa: E402

_last_module = [None]


@pytest.fixture(autouse=True)
def _clear_jax_caches_between_modules(request):
    """Free compiled-executable state between test MODULES.

    jaxlib 0.9.0's XLA:CPU compiler segfaults deterministically ~70% into
    a single-process run of this suite (three separate runs crashed inside
    backend_compile_and_load / the compilation-cache serializer on a
    fuzz-test program that compiles fine in a fresh process, with natives
    disabled too) — accumulated compiler/executable state is the trigger.
    Dropping jit caches at module boundaries keeps the in-process state
    bounded; the on-disk compilation cache makes the re-compiles cheap."""
    mod = request.node.nodeid.split('::', 1)[0]
    if _last_module[0] is not None and mod != _last_module[0]:
        jax.clear_caches()
    _last_module[0] = mod
    yield
