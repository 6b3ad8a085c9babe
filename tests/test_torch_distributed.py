"""The port's health checks of the 'model' axis
(``parallel/distributed.py``: ``collective_health_check``,
``assert_same_step``, ports of quantized_vit_tpu/parallel/
distributed.py:89-172) on the CPU: tp = 1 in this process, tp = 2 as
spawned gloo processes (one group, a module fixture). Every process
contributes 1 through the tensor-parallel reduce-scatter's plain version
(gloo); a process that joins late trips the others' watchdog."""

import time

import pytest
import torch

from quantized_vit_tpu_torch.parallel import (HealthCheckError,
                                              HealthReport, Peers,
                                              assert_same_step,
                                              collective_health_check,
                                              initialize_distributed,
                                              run_processes)

from tests import torch_workers as tw

torch.set_num_threads(1)

WATCHDOG_S = 2.0


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    """tp = 2: a healthy check, one with rank 1 joining after the
    watchdog (its own check then pairs with rank 0's abandoned one, so the
    group stays usable), then assert_same_step agreeing and not."""
    cases = [("health", "ok", (), 30.0), ("health", "late", (1,), WATCHDOG_S),
             ("health", "after", (), 30.0),
             ("same_step", "same", (7, 7)), ("same_step", "stale", (7, 5))]
    return run_processes(tw.run_cases, 2, str(tmp_path_factory.mktemp("s")),
                         args=(cases,), timeout_s=240)


def test_health_check_passes_at_tp1():
    peers = initialize_distributed(device="cpu")
    rep = collective_health_check(peers, timeout_s=30)
    assert isinstance(rep, HealthReport) and rep.ok
    assert (rep.num_devices, rep.num_processes) == (1, 1)
    assert rep.latency_s < 30


def test_health_check_passes_at_tp2(tp2):
    for res in tp2:
        raised, msg, _ = res["ok"]
        assert not raised and "ok=True" in msg and "num_devices=2" in msg
        assert not res["after"][0]


def test_late_rank_trips_the_watchdog(tp2):
    """Rank 0 raises HealthCheckError at its watchdog (a few seconds);
    rank 1, joining late, finds rank 0's pending contribution."""
    raised, msg, seconds = tp2[0]["late"]
    assert raised and "hung for 2.0s" in msg
    assert WATCHDOG_S <= seconds < WATCHDOG_S + 1.5
    assert not tp2[1]["late"][0]


def test_health_check_raises_on_a_wrong_value(monkeypatch):
    from quantized_vit_tpu_torch.parallel import distributed

    monkeypatch.setattr(distributed, "_ones_reduced", lambda peers: 3.0)
    with pytest.raises(HealthCheckError, match="returned 3.0, expected 1.0"):
        collective_health_check(Peers(0, 1, "cpu"))

    def hang(peers):
        time.sleep(5)

    monkeypatch.setattr(distributed, "_ones_reduced", hang)
    t0 = time.monotonic()
    with pytest.raises(HealthCheckError, match="hung for 0.5s"):
        collective_health_check(Peers(0, 1, "cpu"), timeout_s=0.5)
    assert time.monotonic() - t0 < 2


def test_assert_same_step(tp2):
    assert [r["same"] for r in tp2] == [None, None]
    for r in tp2:
        assert "disagree on resume step: min=5 max=7" in r["stale"]
    assert_same_step(3, Peers(0, 1, "cpu"))
