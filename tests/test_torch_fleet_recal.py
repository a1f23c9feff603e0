"""The port's fleet with the §6 recalibration loop against the reference's
single engine: ``conftest.fleet_case_recalibration`` (a full rebuild on
the drifted duke world, at 2, 4 and 8 workers) and ``fleet_case_soak``
(query churn, a worker loss and row-targeted swaps on the scaled-down
soak world, at 1, 2, 4 and 8 workers).  The swaps land on the
reference's ticks on every worker; scores within 1e-5, everything else
exact."""
import pytest

from torch_fleet_cases import (assert_fleet_matches, drive_port, reference,
                               world)

POLICY = dict(scheme="rexcam", s_thresh=.05, t_thresh=.02, exit_t=120)
DRIFT_RECAL = dict(drift_threshold=.02, min_rescues=2, cooldown=60,
                   poll_every=10, window=200)
SOAK_RECAL = dict(drift_threshold=.005, min_rescues=2, cooldown=80,
                  poll_every=10, window=250, targeted=True,
                  row_threshold=.02)


@pytest.mark.parametrize("shards", (2, 4, 8))
def test_recalibrating_fleet_swaps_on_the_reference_ticks(shards):
    w = world("drifted", seed=0, n_queries=8, horizon=500)
    ref = reference("drifted", POLICY, recalibrate=DRIFT_RECAL, seed=0,
                    n_queries=8, horizon=500)
    assert ref[1]["model_epoch"] >= 1
    eng, trace, summary = drive_port(w, POLICY, shards=shards,
                                     recalibrate=DRIFT_RECAL)
    assert_fleet_matches(eng, trace, summary, ref)
    assert len({r["epoch"] for r in trace}) >= 2
    assert int(eng.model.epoch) == eng.model_epoch
    for rep in eng._replicas.values():
        assert rep.model is eng.model and rep.windows is eng._windows


@pytest.mark.parametrize("shards", (1, 2, 4, 8))
def test_soak_fleet_with_churn_loss_and_targeted_swaps(shards):
    w = world("soak", seed=3, n_queries=8)
    C = w["net"].n_cams
    ref = reference("soak", POLICY, recalibrate=SOAK_RECAL, seed=3,
                    n_queries=8, churn_wave=40)
    loss = 90 if shards >= 2 else None
    eng, trace, summary = drive_port(w, POLICY, shards=shards,
                                     recalibrate=SOAK_RECAL, churn_wave=40,
                                     lose_at=loss, lose_worker=1)
    assert_fleet_matches(eng, trace, summary, ref)
    assert eng.rebalances == (1 if loss else 0)
    assert summary["model_epoch"] >= 1 and summary["replay_steps"] > 0
    ctl = eng.recal
    assert ctl.targeted_swaps >= 1 and ctl.full_rebuilds == 0
    assert ctl.rows_reprofiled < C * ctl.targeted_swaps
    for ev in ctl.events:
        assert ev["mode"] == "targeted" and 0 < ev["rows"] < C
