"""The roofline work counts at known shapes, and the bound they give at the
published H100 peaks.

    python -m pytest -q -p no:cacheprovider portbench/checks/check_roofline.py
"""

from __future__ import annotations

import pytest

import stand_in  # noqa: F401
from portbench.harness import cells, device


def test_scan_counts():
    ops, nbytes = cells.roofline("scan").work(b=64, n=45000, d_pad=1024)
    assert ops == 2 * 64 * 45000 * 1024
    assert nbytes == 45000 * 512 + 4 * 64 * 1024 + 4 * 45000 + 4 * 64 * 45000
    # PERF.md's B1 bound at 64 x 45,000 x 1024: 88 us of f32 FMA at 67 TFLOP/s.
    peak = device.PEAKS["NVIDIA H100 80GB HBM3"]
    assert max(ops / peak["f32_flops"], nbytes / peak["bytes_per_s"]) * 1e3 == \
        pytest.approx(0.0880, abs=5e-5)


def test_sign_proxy_counts():
    ops, nbytes = cells.roofline("sign_proxy").work(b=256, n=1_000_000, d_pad=1024)
    assert ops == 0.0
    assert nbytes == 1_000_000 * 128 + 256 * 128 + 4 * 256 * 1_000_000


def test_rotation_counts():
    ops, nbytes = cells.roofline("rotation").work(n=1_000_000, d=768, d_pad=1024)
    assert nbytes == 4 * 1_000_000 * 768 + 4 * 1_000_000 * 1024
    assert ops == 1_000_000 * 768 + 1_000_000 * 1024 * 10
    # Bytes bind: 7.168 GB at 3.35 TB/s.
    peak = device.PEAKS["NVIDIA H100 80GB HBM3"]
    assert nbytes / peak["bytes_per_s"] > ops / peak["f32_flops"]


def test_bound_needs_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a host without one")
    with pytest.raises(RuntimeError):
        device.bound_s(1.0, 1.0)
    with pytest.raises(RuntimeError):
        device.stage_ms(lambda: None)
