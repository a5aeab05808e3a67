"""Dispatch-calibration fingerprint: the crossover is a measurement of
one host and card, so a run on another card must say so loudly, keep the
committed values, and never start a second JAX process to re-measure
(that process would need the card this one already holds)."""
import json

import pytest

from seeksv_tpu.align.engine import BatchAligner

H100 = "NVIDIA H100 80GB HBM3"


class _FakeDev:
    platform = "gpu"
    device_kind = H100

    def __str__(self):
        return "cuda:0"


@pytest.fixture
def fake_gpu(monkeypatch):
    import jax
    monkeypatch.setattr(jax, "devices", lambda: [_FakeDev()])
    yield
    BatchAligner._load_calibration.cache_clear()


def _write(p, fingerprint):
    p.write_text(json.dumps({"crossover_cells": 123,
                             "fingerprint": fingerprint}))
    BatchAligner._load_calibration.cache_clear()


def test_stale_on_device_mismatch(tmp_path, monkeypatch, fake_gpu):
    p = tmp_path / "cal.json"
    monkeypatch.setenv("SEEKSV_TPU_DISPATCH_CALIB", str(p))
    _write(p, {"device_kind": "NVIDIA A100-SXM4-80GB", "platform": "gpu"})
    reason = BatchAligner.calibration_stale()
    assert reason is not None and "A100" in reason and H100 in reason


def test_fresh_fingerprint_not_stale_and_crossover_loaded(
        tmp_path, monkeypatch, fake_gpu):
    p = tmp_path / "cal.json"
    monkeypatch.setenv("SEEKSV_TPU_DISPATCH_CALIB", str(p))
    _write(p, {"device_kind": H100, "platform": "gpu"})
    assert BatchAligner.calibration_stale() is None
    assert BatchAligner._calibrated_min_device_cells() == 123


def test_missing_fingerprint_is_stale(tmp_path, monkeypatch, fake_gpu):
    p = tmp_path / "cal.json"
    monkeypatch.setenv("SEEKSV_TPU_DISPATCH_CALIB", str(p))
    p.write_text(json.dumps({"crossover_cells": 123}))
    BatchAligner._load_calibration.cache_clear()
    assert "fingerprint" in BatchAligner.calibration_stale()


def test_mismatch_warns_keeps_crossover_and_starts_no_process(
        tmp_path, monkeypatch, fake_gpu):
    p = tmp_path / "cal.json"
    monkeypatch.setenv("SEEKSV_TPU_DISPATCH_CALIB", str(p))
    _write(p, {"device_kind": "NVIDIA A100-SXM4-80GB", "platform": "gpu"})
    import subprocess

    def no_process(*a, **kw):
        raise AssertionError("calibration check started a process")

    monkeypatch.setattr(subprocess, "run", no_process)
    monkeypatch.setattr(subprocess, "Popen", no_process)
    logs = []
    BatchAligner.check_calibration(log=logs.append)
    assert len(logs) == 1
    assert "WARNING" in logs[0] and "A100" in logs[0] and H100 in logs[0]
    assert "123" in logs[0]
    assert BatchAligner._calibrated_min_device_cells() == 123


def test_matching_card_is_silent(tmp_path, monkeypatch, fake_gpu):
    p = tmp_path / "cal.json"
    monkeypatch.setenv("SEEKSV_TPU_DISPATCH_CALIB", str(p))
    _write(p, {"device_kind": H100, "platform": "gpu"})
    logs = []
    BatchAligner.check_calibration(log=logs.append)
    assert logs == []


def test_no_accel_never_stale(tmp_path, monkeypatch):
    # CPU-only jax: host path serves everything; nothing to compare
    import jax

    class _Cpu:
        platform = "cpu"
        device_kind = "cpu"

        def __str__(self):
            return "TFRT_CPU_0"

    monkeypatch.setattr(jax, "devices", lambda: [_Cpu()])
    p = tmp_path / "cal.json"
    monkeypatch.setenv("SEEKSV_TPU_DISPATCH_CALIB", str(p))
    _write(p, {"device_kind": "NVIDIA A100-SXM4-80GB", "platform": "gpu"})
    assert BatchAligner.calibration_stale() is None
    BatchAligner._load_calibration.cache_clear()


def test_committed_calibration_names_its_card():
    """The committed artifacts carry the card they were measured on."""
    import os
    here = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "seeksv_tpu", "align")
    with open(os.path.join(here, "dispatch_calibration.json")) as f:
        fp = json.load(f)["fingerprint"]
    assert fp["platform"] == "gpu" and fp["device_kind"]
    assert fp["nvidia_smi"] and " W" in fp["nvidia_smi"]
    with open(os.path.join(here, "device_align_calibration.json")) as f:
        dal = json.load(f)
    assert dal["device_kind"] == fp["device_kind"] and dal["nvidia_smi"]
