"""The profiler's record census refuses the CPU, and ``device_ms`` takes a
trace that lost records again with more launches and a longer wait, then
refuses."""

import contextlib
from types import SimpleNamespace

import pytest
import torch

from parallel_heat_tpu_torch import bench_kernels as bk
from parallel_heat_tpu_torch.tools import profiler_records as pr


def test_census_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pr.main(["--seconds", "0"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def _fake_traces(monkeypatch, kept):
    """``card_trace`` replaced by traces that keep ``kept[i]`` records of
    1 ms launches on the i-th trace; returns the waits asked for."""
    pads = []

    @contextlib.contextmanager
    def trace(pad_s=bk.TRACE_PAD_S):
        n = kept[len(pads)]
        pads.append(pad_s)
        yield SimpleNamespace(key_averages=lambda: [SimpleNamespace(
            key="heat_x_kernel", count=n, self_device_time_total=1e3 * n)])

    monkeypatch.setattr(bk, "card_trace", trace)
    return pads


@pytest.mark.parametrize("kept, pads, ok", [
    ([40], [1], True),
    ([8, 56], [1, 4], True),
    ([0, 81, 113], [1, 4, 16], True),
    ([8, 8, 8], [1, 4, 16], False),
])
def test_device_ms_retries_with_more_launches_and_longer_waits(
        monkeypatch, kept, pads, ok):
    asked = _fake_traces(monkeypatch, kept)
    calls = []
    if ok:
        assert bk.device_ms(lambda: calls.append(1), "heat_x_kernel") == 1.0
    else:
        with pytest.raises(RuntimeError, match="kept 8 records of 160"):
            bk.device_ms(lambda: calls.append(1), "heat_x_kernel")
    assert asked == [bk.TRACE_PAD_S * p for p in pads]
    assert len(calls) == 1 + sum(40 * 2 ** i for i in range(len(pads)))
