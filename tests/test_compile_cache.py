"""cli/common.enable_compilation_cache: the cache lives in
JAX_COMPILATION_CACHE_DIR when that is set, else <checkout>/.jax_cache."""
import os

import jax
import pytest

from hicpeaks_tpu.cli.common import enable_compilation_cache

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_KEYS = ('jax_compilation_cache_dir',
         'jax_persistent_cache_min_compile_time_secs',
         'jax_persistent_cache_min_entry_size_bytes')


@pytest.fixture
def restore_cache_config():
    saved = {k: getattr(jax.config, k) for k in _KEYS}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


@pytest.mark.parametrize('env_set', [True, False])
def test_compilation_cache_dir(env_set, tmp_path, monkeypatch,
                               restore_cache_config):
    if env_set:
        want = str(tmp_path / 'xla-cache')
        monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', want)
    else:
        want = os.path.join(_CHECKOUT, '.jax_cache')
        monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    assert enable_compilation_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert os.path.isdir(want)
