"""The port's soak harness (fishnet_tpu_torch.resilience.soak), the
counterpart of ``tests/test_soak.py``: the canned fault plan (acquire
flaps, submit failures, one engine-spawn fault, one device_step crash)
and the overload phase through the whole harness on the CPU, asserting
the contract — every acquired batch submitted exactly once (ledger
clean, server-side counts all 1), one degradation down the CPU's ladder
(xla -> host-material) and one pool respawn observed through the
counters, and /metrics exporting all four resilience families."""

import pytest

from fishnet_tpu.resilience import soak as jax_soak
from fishnet_tpu_torch.resilience import soak
from fishnet_tpu_torch.resilience.supervisor import ladder_for

pytestmark = pytest.mark.anyio


async def test_soak_canned_plan_on_the_cpu():
    assert soak.CANNED_PLAN == jax_soak.CANNED_PLAN
    assert soak.PHASE_C_PLAN == jax_soak.PHASE_C_PLAN
    assert soak.REQUIRED_FAMILIES == jax_soak.REQUIRED_FAMILIES
    report = await soak.run_soak(device="cpu")
    assert report["ok"], report
    # Exactly-once: nothing lost, nothing duplicated, all submitted.
    assert report["ledger"]["lost"] == []
    assert report["ledger"]["duplicated"] == []
    assert report["ledger"]["submitted"] == report["phase_a"]["jobs"]
    # Whole-run view (phase C's overload traffic included): still clean.
    assert report["ledger_final"]["lost"] == []
    assert report["ledger_final"]["duplicated"] == []
    assert all(
        c == 1
        for c in report["phase_a"]["server_submission_counts"].values()
    )
    # Recovery machinery observed via the counters, one rung down the
    # CPU's ladder (the TPU's steps fused -> xla).
    frm, to = ladder_for("cpu")
    assert report["counters"]["requeued"] >= 1
    assert report["counters"]["respawns"] >= 1
    assert report["counters"]["degradation"]["from"] == frm
    assert report["counters"]["degradation"]["to"] == to
    assert report["counters"]["degradation"]["count"] >= 1
    assert report["phase_b"]["rung"] == to == "host-material"
    # Overload: shed, admitted, bounded.
    c = report["phase_c"]
    assert c["shed"] >= 1 and c["admitted"] >= 1
    assert c["max_throughput_depth"] <= c["depth_bound"]
    # The metric-family contract.
    assert set(report["metric_families"]) == set(soak.REQUIRED_FAMILIES)


def test_soak_cli_rejects_bad_plan(capsys):
    assert soak.main(["--plan", "nosuch.site:nth=1:error",
                      "--device", "cpu"]) == 1
    assert "SOAK FAILED" in capsys.readouterr().err


def test_soak_cli_refuses_a_missing_gpu(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert soak.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
