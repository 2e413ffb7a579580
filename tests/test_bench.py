"""bench.py's record shape and its refusal to measure anything but the
GPU (the measurements themselves run only on the card)."""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import bench  # noqa: E402


def test_emit_record_shape(capsys):
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
              "count": 1, "card": "NVIDIA H100 80GB HBM3, 700.00 W"}
    bench._emit_record(123.4, device)
    line = capsys.readouterr().out.strip()
    rec = json.loads(line)
    assert rec == {"metric": "geomorphons_throughput_lookup50",
                   "value": 123.4, "unit": "Mpix/s",
                   "vs_baseline": round(123.4 / bench.BASELINE_MPIX_S,
                                        1),
                   "device": device}


def test_main_refuses_cpu(capsys):
    """No GPU: exit non-zero before any record is printed."""
    with pytest.raises(SystemExit) as e:
        bench.main()
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_device_fields_name_the_device():
    d = bench.device_fields()
    assert d["platform"] == "cpu" and d["count"] >= 1
    assert set(d) == {"platform", "kind", "count", "card"}
