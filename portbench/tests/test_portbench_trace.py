"""The traced window's reading: a training's epochs run with the trace
off count the median device time of its traced epochs after the first."""

import pytest
import torch

from harness.trace import _overlap, _untraced_busy, summarize


class _Event:
    def __init__(self, start, end, name='k'):
        self._s, self._e, self._n = start, end, name

    def device_type(self):
        return torch.autograd.DeviceType.CUDA

    def is_user_annotation(self):
        return False

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def name(self):
        return self._n


class _Results:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


BUSY = [[0, 5], [10, 14], [20, 23], [30, 34]]
# the first epoch captures the step's graph; 9..19, 19..29, 29..39 read
# 4, 3 and 4 ns of device time
EPOCHS = [(0, 9), (9, 19), (19, 29), (29, 39)]


@pytest.mark.parametrize('a, b, want', [(0, 5, 5), (9, 19, 4), (12, 21, 3),
                                        (35, 50, 0)])
def test_overlap(a, b, want):
    assert _overlap(BUSY, a, b) == want


def test_untraced_epochs_count_the_median_traced_epoch():
    spans = [(0, 100, 'pb.train')]
    assert _untraced_busy(BUSY, spans, [(40, 100, 5)], EPOCHS) == [
        (40, 100, 20)]
    # never more than the stretch itself
    assert _untraced_busy(BUSY, spans, [(40, 50, 5)], EPOCHS) == [
        (40, 50, 10)]


def test_summary_keeps_the_untraced_stretch_in_the_window():
    events = _Results([_Event(a, b) for a, b in BUSY])
    spans = [(0, 100, 'pb.job'), (0, 100, 'pb.train')]
    s = summarize(events, spans, [(40, 100, 5)], EPOCHS)
    assert s['window_s'] == pytest.approx(100e-9)
    assert s['busy_s'] == pytest.approx((16 + 20) * 1e-9)
    assert s['traced_window_s'] == pytest.approx(40e-9)
    assert s['traced_busy_s'] == pytest.approx(16e-9)
    assert s['idle']['pb.train, untraced epochs'][1] == pytest.approx(40e-9)
