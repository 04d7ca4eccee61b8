"""The port's micro-benchmarks (deepdish_tpu_torch/tools/profile_micro.py)
on the CPU: each group runs through `main` under --device cpu at one rep
and tiny sizes and prints one JSON line last with its legs' finite
numbers (no device ms on the CPU); the trk legs' inputs, the JAX tool's
np.random.RandomState(0) draws, give the JAX ops' outputs: the LSAP
assignment exactly, the Kalman results within 1e-5, and the table after
`tracker.step` on 32 live tracks (ids and states) exactly."""
import json
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp
import torch

from deepdish_tpu import tracker as jtt
from deepdish_tpu.ops import kalman as jkalman
from deepdish_tpu.ops.assignment import solve_lsap as j_solve_lsap
from deepdish_tpu_torch.tools import profile_micro as pm
from test_torch_models import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.timeout(300)
TINY = ["--device", "cpu", "--reps", "1", "--batch", "1", "--size", "64",
        "--mars-batch", "2"]
LEGS = {"ssd": 4, "mars": 3, "trk": 8}    # trk: no kernel leg on the CPU


@pytest.mark.parametrize("group", pm.GROUPS)
def test_group_prints_one_json_line(group, capsys):
    got = pm.main(TINY + ["--only", group])
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert line == json.loads(json.dumps(got))
    assert sum(1 for o in out if o.startswith("{")) == 1
    assert line["platform"] == "cpu" and line["device"]["name"] is None
    assert line["groups"] == [group] and len(line["legs"]) == LEGS[group]
    for row in line["legs"]:
        assert row["group"] == group and row["device_ms"] is None
        assert math.isfinite(row["host_ms"]) and row["host_ms"] > 0
        assert math.isfinite(row["host_syncs"]) and row["host_syncs"] >= 0
    assert line["lsap_kernel_equal"] is None          # no kernel here


def test_trk_legs_match_jax():
    out = pm.trk_legs(pm.Timer(torch.device("cpu"), 1))
    x, _ = pm.trk_inputs("cpu")
    want = np.asarray(j_solve_lsap(jnp.asarray(x["cost"]), 64, 64))
    np.testing.assert_array_equal(out["lsap"].numpy(), want)
    np.testing.assert_array_equal(out["argsort"].numpy(),
                                  np.argsort(x["v"], kind="stable"))
    for got, want in ((out["predict"],
                       jkalman.predict_v(x["mean"], x["cov"])),
                      ((out["gating"],),
                       (jkalman.gating_distance_v(x["mean"], x["cov"],
                                                  x["meas"]),)),
                      (out["update"],
                       jkalman.update_v(x["mean"], x["cov"], x["z64"]))):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)
    cfg = pm.tracker_config()
    jcfg = jtt.TrackerConfig(max_tracks=cfg.max_tracks,
                             max_detections=cfg.max_detections,
                             gallery_size=cfg.gallery_size,
                             num_labels=cfg.num_labels)
    dets = jtt.Detections(
        tlwh=jnp.asarray(x["tlwh"]), confidence=jnp.ones((32,)),
        label=jnp.zeros((32,), jnp.int32),
        feature=jnp.asarray(x["feature"]), valid=jnp.ones((32,), bool))
    table = jtt.create_table(jcfg)
    for _ in range(2):
        table, _ = jtt.step(jcfg, table, dets)
    for name in ("track_id", "state"):
        np.testing.assert_array_equal(
            getattr(out["table_live"], name).numpy(),
            np.asarray(getattr(table, name)))
    table, _ = jtt.step(jcfg, table, dets)
    assert int((np.asarray(table.track_id) > 0).sum()) == 32
    for name in ("track_id", "state"):
        np.testing.assert_array_equal(
            getattr(out["table_after"], name).numpy(),
            np.asarray(getattr(table, name)))


def test_unknown_group_refused():
    with pytest.raises(ValueError, match="--only"):
        pm.main(["--device", "cpu", "--only", "ssd,nope"])
