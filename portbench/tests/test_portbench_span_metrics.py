"""The readers of the port's own spans and device events:
``update_device_ms.train``, ``host_wait_share.train`` and
``host_read_wait_share.train``, each on a hand-made account of the
recorder, and silent when it is empty or saw another number of updates
than were traced."""

from __future__ import annotations

import pytest

from portbench import spec

MS = 1_000_000  # host nanoseconds a millisecond


def _account(updates=2):
    """Two restricted updates recorded: the first waits 2 ms on its host
    read, the second 1 ms on the host's launch, then 1 ms on its read."""
    from primekg_rgcn_tpu_torch.utils.telemetry import account

    spans, runs = [], []
    for u in range(updates):
        h = 20 * MS * u
        d = 20.0 * u
        top = len(spans)
        spans += [("train.update", h, h + 10 * MS, None, False, 1),
                  ("graphs.replay", h, h + MS, top, False, 0),
                  ("restricted.host_read", h + MS, h + 5 * MS, top, True, 0),
                  ("graphs.replay", h + 5 * MS, h + 6 * MS, top, False, 0)]
        wait = 2.0 if u == 0 else 1.0
        runs += [(("ranges",), "replay", top + 1, d, d + 4.0, h, h + MS),
                 (("micro", True, 0), "replay", top + 3, d + 4.0 + wait,
                  d + 19.0, h + 5 * MS, h + 6 * MS)]
    return account(runs, spans)


@pytest.fixture
def recorded(monkeypatch):
    """``recorded(summary)``: the recorder reads ``summary``."""
    from primekg_rgcn_tpu_torch.utils import telemetry

    def use(summary):
        monkeypatch.setattr(telemetry, "recorded", lambda: summary)
    return use


LAYER = {"updates_traced": 2, "restricted": True}


def _read(name, layer=LAYER):
    return spec.reader(name).read(layer, None)


def test_update_device_ms_is_the_median_update(recorded):
    recorded(_account())
    # Update 0: 4 + (19 - 6) = 17 ms; update 1: 4 + (19 - 5) = 18 ms.
    assert _read("update_device_ms.train") == pytest.approx(17.5)


def test_host_wait_share_over_the_stretch(recorded):
    recorded(_account())
    # Waits: 2 ms (read), 1 ms (launch into update 1), 1 ms (read) over
    # a stretch of 39 ms.
    assert _read("host_wait_share.train") == pytest.approx(400.0 / 39.0)


def test_host_read_wait_share(recorded):
    recorded(_account())
    assert _read("host_read_wait_share.train") == pytest.approx(
        300.0 / 39.0)
    assert _read("host_read_wait_share.train",
                 dict(LAYER, restricted=False)) is None


@pytest.mark.parametrize("name", ["update_device_ms.train",
                                  "host_wait_share.train",
                                  "host_read_wait_share.train"])
def test_silent_when_empty_or_the_updates_differ(recorded, name):
    from primekg_rgcn_tpu_torch.utils.telemetry import account

    recorded(account([], []))
    assert _read(name) is None
    recorded(_account(updates=3))
    assert _read(name) is None
    recorded(dict(_account(), dropped=1))
    assert _read(name) is None
    recorded(_account())
    assert _read(name) is not None


@pytest.mark.parametrize("name", ["update_device_ms.train",
                                  "host_wait_share.train",
                                  "host_read_wait_share.train"])
def test_silent_on_a_port_without_the_recorder(monkeypatch, name):
    """A port without ``telemetry.recorded`` (an older checkout) gives no
    metric and raises nothing."""
    from primekg_rgcn_tpu_torch.utils import telemetry

    monkeypatch.delattr(telemetry, "recorded")
    assert _read(name) is None
