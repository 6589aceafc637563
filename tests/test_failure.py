"""Failure detection / elastic recovery / fault injection tests.

The reference has no failure handling at all (SURVEY.md section 5); these
tests cover the subsystem we add: heartbeat staleness detection, the
collective liveness probe on the fake 8-device CPU mesh, and bit-exact
resume-after-injected-fault through the checkpoint layer.
"""

import numpy as np
import pytest

import jax

from pathtracerap.utils.failure import (
    FaultInjector,
    Heartbeat,
    InjectedFault,
    liveness_probe,
    run_with_recovery,
)


def test_heartbeat_roundtrip_and_staleness(tmp_path):
    hb0 = Heartbeat(str(tmp_path), host_id=0)
    hb1 = Heartbeat(str(tmp_path), host_id=1)
    hb0.beat(iteration=7, extra={"phase": "render"})
    hb1.beat(iteration=7)
    got = hb0.read(0)
    assert got["iteration"] == 7 and got["phase"] == "render"
    # fresh: nobody stale; host 2 never beat: stale; aged-out host 1: stale
    assert hb0.stale_hosts([0, 1], timeout_s=60) == []
    assert hb0.stale_hosts([0, 1, 2], timeout_s=60) == [2]
    future = got["ts"] + 120.0
    assert hb0.stale_hosts([0, 1], timeout_s=60, now=future) == [0, 1]


def test_liveness_probe_counts_all_devices():
    n = len(jax.devices())
    assert liveness_probe() == n


def test_fault_injector_fires_once():
    inj = FaultInjector(fail_at=2)
    inj.maybe_fail(0)
    inj.maybe_fail(1)
    with pytest.raises(InjectedFault):
        inj.maybe_fail(2)
    inj.maybe_fail(2)  # healed after restart


def _make_step(shape):
    # Deterministic chunk function keyed only on (samples_done, n) — the
    # stateless-RNG property run_with_recovery relies on.
    def step_chunk(accum, samples_done, n):
        contrib = np.zeros(shape, np.float32)
        for s in range(samples_done, samples_done + n):
            contrib += np.float32(1.0 / (1 + s))
        return accum + contrib

    return step_chunk


def test_recovery_resumes_bit_identical(tmp_path):
    shape = (16, 3)
    cfg = {"w": 4, "h": 4, "spp": 10}
    step = _make_step(shape)

    # Unbroken run (no faults).
    clean = run_with_recovery(
        step, total_samples=10, chunk_samples=3, accum_shape=shape,
        seed=0, config=cfg, checkpoint_path=str(tmp_path / "clean.ckpt"),
    )
    assert clean["samples_done"] == 10 and clean["restarts"] == 0

    # Faulted run: dies at chunk 2, restarts, resumes from checkpoint.
    restarts_seen = []
    faulty = run_with_recovery(
        step, total_samples=10, chunk_samples=3, accum_shape=shape,
        seed=0, config=cfg, checkpoint_path=str(tmp_path / "faulty.ckpt"),
        injector=FaultInjector(fail_at=2),
        on_restart=lambda k, e: restarts_seen.append(type(e).__name__),
    )
    assert faulty["restarts"] == 1
    assert restarts_seen == ["InjectedFault"]
    np.testing.assert_array_equal(faulty["accum"], clean["accum"])


def test_recovery_ignores_mismatched_config_checkpoint(tmp_path):
    shape = (4, 3)
    step = _make_step(shape)
    path = str(tmp_path / "c.ckpt")
    run_with_recovery(step, total_samples=4, chunk_samples=2, accum_shape=shape,
                      seed=0, config={"spp": 4}, checkpoint_path=path)
    # Different config: must restart from zero, not reuse stale accum.
    out = run_with_recovery(step, total_samples=2, chunk_samples=2,
                            accum_shape=shape, seed=0, config={"spp": 2},
                            checkpoint_path=path)
    np.testing.assert_array_equal(out["accum"], _make_step(shape)(
        np.zeros(shape, np.float32), 0, 2))


def test_recovery_gives_up_after_max_restarts(tmp_path):
    shape = (2, 3)

    def always_fail(accum, samples_done, n):
        raise RuntimeError("hard fault")

    with pytest.raises(RuntimeError, match="hard fault"):
        run_with_recovery(
            always_fail, total_samples=4, chunk_samples=2, accum_shape=shape,
            seed=0, config={}, checkpoint_path=str(tmp_path / "x.ckpt"),
            max_restarts=2,
        )
