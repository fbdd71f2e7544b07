"""The port's resilience/supervisor.py: the submit circuit breaker against
the JAX package's on the same event sequences, and the device-dependent
degradation ladder (on CUDA it steps fused -> host-material, both on
the hand kernel, and never enters "xla", the plain version)."""

import pytest
import torch

from fishnet_tpu.resilience.supervisor import CircuitBreaker as JaxBreaker
from fishnet_tpu_torch.nnue.weights import NnueWeights
from fishnet_tpu_torch.resilience.supervisor import (
    CircuitBreaker,
    RespawnBudgetExhausted,
    ServiceSupervisor,
    ladder_for,
)
from fishnet_tpu_torch.search import eval_cache
from fishnet_tpu_torch.search.service import SearchService


@pytest.fixture(autouse=True)
def fresh_port_cache():
    """The port's process-wide eval cache, reset around each test:
    tests/conftest.py resets only the JAX package's, and a cache warmed
    by an earlier test would skip this one's dispatches."""
    eval_cache.reset_cache()
    yield
    eval_cache.reset_cache()


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread: the port's small CPU gathers gain
    nothing from more, and under the parallel tier-1 run torch's default
    pool starves other test processes' wall-clock budgets (ROADMAP C8,
    C10)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

#: (event, clock advance before it): "allow", "ok" (success), "fail".
SEQUENCES = {
    "opens-after-threshold": [("fail", 0)] * 3 + [("allow", 0)],
    "half-open-probe-closes": [("fail", 0)] * 3 + [
        ("allow", 5), ("allow", 0), ("ok", 0), ("allow", 0)],
    "failed-probe-reopens": [("fail", 0)] * 3 + [
        ("allow", 5), ("fail", 0), ("allow", 1), ("allow", 5)],
    "success-resets-count": [("fail", 0), ("fail", 0), ("ok", 0),
                             ("fail", 0), ("fail", 0), ("allow", 0)],
}


class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def _trace(cls, events):
    clock = _Clock()
    breaker = cls(failure_threshold=3, cooldown_seconds=4.0,
                  name="port-parity", clock=clock)
    out = []
    for event, advance in events:
        clock.now += advance
        if event == "allow":
            got = breaker.allow()
        elif event == "ok":
            got = breaker.record_success()
        else:
            got = breaker.record_failure()
        out.append((got, breaker.state, breaker.remaining_cooldown()))
    return out


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_breaker_matches_the_jax_breaker(name):
    assert _trace(CircuitBreaker, SEQUENCES[name]) == \
        _trace(JaxBreaker, SEQUENCES[name])


class _Logger:
    def __init__(self):
        self.errors, self.infos = [], []

    def error(self, msg):
        self.errors.append(msg)

    def info(self, msg):
        self.infos.append(msg)


def test_cuda_ladder_steps_to_host_material_and_never_to_xla():
    assert ladder_for("cuda") == ("fused", "host-material")
    assert ladder_for("cpu") == ("xla", "host-material")
    built, logger = [], _Logger()
    sup = ServiceSupervisor(lambda rung: built.append(rung) or rung,
                            rungs=ladder_for("cuda"), degrade_after=2,
                            max_respawns=10, logger=logger)
    for _ in range(6):  # one start, then five rapid deaths
        sup.build()
    assert built == ["fused", "fused", "host-material", "host-material",
                     "host-material", "host-material"]
    assert "xla" not in built
    assert sup.rung == "host-material" and sup.respawns == 5
    assert logger.errors == [
        "Degrading eval path fused -> host-material after repeated service "
        "deaths."]


def test_respawn_budget_and_unknown_rungs():
    sup = ServiceSupervisor(lambda rung: rung, rungs=ladder_for("cpu"),
                            max_respawns=2)
    sup.build()
    sup.build()
    sup.build()
    with pytest.raises(RespawnBudgetExhausted):
        sup.build()
    with pytest.raises(ValueError, match="unknown rungs"):
        ServiceSupervisor(lambda rung: rung, rungs=("triton",))


def test_service_refuses_a_rung_its_device_does_not_run():
    w = NnueWeights.random(seed=0)
    with pytest.raises(ValueError, match="does not run on cpu"):
        SearchService(weights=w, device="cpu", psqt_path="fused",
                      pool_slots=8, batch_capacity=64, tt_bytes=1 << 20)
    for rung in ladder_for("cpu"):
        svc = SearchService(weights=w, device="cpu", psqt_path=rung,
                            pool_slots=8, batch_capacity=64, tt_bytes=1 << 20)
        try:
            assert svc.psqt_path == rung and svc.is_alive()
        finally:
            svc.close()
        assert not svc.is_alive()
