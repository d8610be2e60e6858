"""chip_smoke.py: its contract pieces (on any host) and its GPU checks
(``gpu`` marker: they skip without a GPU; chip_smoke.py runs them on the
card)."""
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


def _gpu_or_skip():
    import jax
    try:
        return jax.devices('gpu')
    except RuntimeError:
        pytest.skip('needs a GPU; chip_smoke.py runs this on the card')


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu()
    assert exc.value.code not in (0, None)


def test_result_line_has_contract_keys():
    class Dev:
        platform = 'gpu'
        device_kind = 'NVIDIA H100 80GB HBM3'

    obj = json.loads(chip_smoke.result_line([Dev()]))
    assert obj == {'ok': True, 'device': {
        'platform': 'gpu', 'kind': 'NVIDIA H100 80GB HBM3', 'count': 1}}


@pytest.mark.gpu
def test_scan_passes_match_cpu_backend():
    """Pass A counts and pass B captures are bit-identical between the
    GPU and the CPU backend (nonnegative adds in a fixed order)."""
    _gpu_or_skip()
    from hicpeaks_tpu.core.config import HiccupsConfig
    bands, _, _ = chip_smoke.bench_bands(L=1024, maxapart=500_000, ww_min=3)
    cfg = HiccupsConfig(pw=(1, 2), ww=(3, 5), maxapart=500_000)
    equal_a, ulps_b = chip_smoke.scan_vs_cpu(bands, cfg)
    assert equal_a
    assert ulps_b == 0


@pytest.mark.gpu
def test_chunk_hist_exact_on_gpu():
    """The int32 scatter-add histogram equals np.bincount on the GPU,
    with most pixels contending for the (0, 0) trash cell."""
    _gpu_or_skip()
    bands, _, _ = chip_smoke.bench_bands(L=1024, maxapart=500_000)
    exact, _, _ = chip_smoke.hist_check(bands)
    assert exact
