"""Port parity of tracker.step: deepdish_tpu_torch (plain LSAP on the CPU)
against deepdish_tpu (JAX on the CPU) frame by frame on randomised
detection streams. Ids, states, matched detections, deletions, hits, ages
and label votes are integers and must match exactly; boxes and the gallery
are float32 with a stated tolerance. The small gallery (G = 16) makes the
ring wrap, so the ring write is covered too. The step batched over a
leading stream axis is held, stream by stream, to the same streams
stepped alone."""
import pytest

jax = pytest.importorskip("jax")  # the reference side needs JAX

import numpy as np
import torch

from deepdish_tpu import tracker as jt
from deepdish_tpu_torch import tracker as pt
from deepdish_tpu_torch.tracker import matching

F = 32
_EXACT = ("track_id", "state", "matched_det", "deleted_id", "hits", "age",
          "time_since_update", "label_count")


class World:
    """Objects moving at constant velocity with jittered boxes, noisy
    appearance features, misses and a shuffled detection order."""

    def __init__(self, rng, miss_prob=0.1, jitter=2.0):
        self.rng = rng
        self.objs = {}
        self.miss_prob = miss_prob
        self.jitter = jitter
        self._next = 0

    def spawn(self, label=0):
        r = self.rng
        self.objs[self._next] = dict(
            pos=r.uniform(100, 500, size=2), vel=r.uniform(-8, 8, size=2),
            size=r.uniform(30, 60, size=2),
            feat=r.normal(size=F).astype(np.float32), label=label)
        self._next += 1

    def kill_oldest(self):
        if self.objs:
            del self.objs[min(self.objs)]

    def frame(self):
        dets = []
        for o in self.objs.values():
            o["pos"] += o["vel"]
            if self.rng.uniform() < self.miss_prob:
                continue
            tl = o["pos"] + self.rng.normal(0, self.jitter, size=2)
            wh = o["size"] * (1 + self.rng.normal(0, 0.02, size=2))
            feat = (o["feat"] + self.rng.normal(0, 0.05, size=F)
                    ).astype(np.float32)
            dets.append((np.r_[tl, wh].astype(np.float32),
                         float(self.rng.uniform(0.5, 1.0)), int(o["label"]),
                         feat))
        self.rng.shuffle(dets)
        return dets


def _run(seed, steps, lsap_impl="xla", miss_prob=0.1, max_age=10):
    rng = np.random.RandomState(seed)
    world = World(rng, miss_prob=miss_prob)
    kw = dict(max_tracks=16, max_detections=8, feature_dim=F,
              gallery_size=16, pending_size=8, num_labels=4, max_age=max_age)
    jcfg = jt.TrackerConfig(lsap_impl=lsap_impl, **kw)
    pcfg = pt.TrackerConfig(**kw)
    jtab = jt.create_table(jcfg)
    ptab = pt.create_table(pcfg, device="cpu")
    matched_frames = 0
    for s in range(steps):
        if s % 5 == 0 and len(world.objs) < 8:
            world.spawn(label=rng.randint(0, 4))
        if s % 13 == 12:
            world.kill_oldest()
        dets = world.frame()
        cols = ([d[0] for d in dets], [d[1] for d in dets],
                [d[2] for d in dets], [d[3] for d in dets])
        jtab, jo = jt.step(jcfg, jtab, jt.pack_detections(jcfg, *cols))
        ptab, po = pt.step(pcfg, ptab,
                           pt.pack_detections(pcfg, *cols, device="cpu"))
        for name in _EXACT:
            np.testing.assert_array_equal(
                getattr(po, name).numpy(), np.asarray(getattr(jo, name)),
                err_msg=f"seed={seed} frame={s} field={name}")
        # Kalman boxes: float32 products summed in another order
        np.testing.assert_allclose(po.tlwh.numpy(), np.asarray(jo.tlwh),
                                   rtol=1e-5, atol=1e-3)
        matched_frames += int((po.matched_det.numpy() >= 0).any())
    np.testing.assert_array_equal(ptab.gallery_count.numpy(),
                                  np.asarray(jtab.gallery_count))
    # unit features copied, never recomputed: exact up to the one
    # normalisation division (1e-6)
    np.testing.assert_allclose(ptab.gallery.numpy(),
                               np.asarray(jtab.gallery), atol=1e-6)
    assert matched_frames > steps // 2
    return ptab


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tracker_stream(seed):
    _run(seed, steps=50)


def test_tracker_long_occlusion():
    """Frequent misses: deep cascade levels and age-outs."""
    _run(7, steps=60, miss_prob=0.35, max_age=6)


def test_tracker_against_pallas_interpret():
    """The JAX side solves with the Pallas kernel in interpret mode."""
    _run(11, steps=12, lsap_impl="pallas_interpret")


def test_create_table_needs_a_device():
    cfg = pt.TrackerConfig(max_tracks=4, max_detections=2, feature_dim=8,
                           gallery_size=8, pending_size=2)
    tab = pt.create_table(cfg, device="cpu")
    assert tab.mean.device.type == "cpu" and int(tab.next_id) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pt.create_table(cfg)


# streams of one batch: "walkers" and "occluded" (deep cascade levels,
# age-outs) confirm tracks, "empty" has no valid detection (no rows in
# the IoU stage while the others have some), "noise" has detections that
# never make a confirmed track
MIXES = {"mixed": ("walkers", "occluded", "empty", "noise"),
         "crowd": ("occluded", "walkers", "occluded", "walkers", "noise"),
         "one": ("occluded",)}


def _stream_dets(kind, world, rng, frame):
    if kind == "empty":
        return []
    if kind == "noise":
        return [(np.r_[rng.uniform(0, 2000, 2), 20, 40].astype(np.float32),
                 0.9, 0, rng.normal(size=F).astype(np.float32))
                for _ in range(3)]
    if frame % 5 == 0 and len(world.objs) < 8:
        world.spawn(label=rng.randint(0, 4))
    if frame % 13 == 12:
        world.kill_oldest()
    return world.frame()


@pytest.mark.parametrize("seed,mix", [(0, "mixed"), (1, "mixed"),
                                      (2, "crowd"), (3, "one")])
def test_batched_step_equals_streams_alone(seed, mix, monkeypatch):
    """S streams through one batched step give, frame by frame, what S
    single-table steps give (integers exact, floats within 1e-5), with one
    LSAP launch of B = S a batched cascade level and at most one for the
    IoU stage."""
    kinds = MIXES[mix]
    S = len(kinds)
    cfg = pt.TrackerConfig(max_tracks=16, max_detections=8, feature_dim=F,
                           gallery_size=16, pending_size=8, num_labels=4,
                           max_age=6)
    launches, stages = [], []
    solve, solve_stage = matching.solve_lsap, \
        matching.masked_min_cost_matching
    monkeypatch.setattr(matching, "solve_lsap", lambda c, sz: (
        launches.append(c.shape[0]), solve(c, sz))[1])
    monkeypatch.setattr(matching, "masked_min_cost_matching",
                        lambda cost, rm, rk, cm, dist, K: (
                            stages.append(dist), solve_stage(
                                cost, rm, rk, cm, dist, K))[1])
    rngs = [np.random.RandomState(seed * 100 + i) for i in range(S)]
    worlds = [World(r, miss_prob=0.35 if k == "occluded" else 0.1)
              for r, k in zip(rngs, kinds)]
    alone = [pt.create_table(cfg, device="cpu") for _ in range(S)]
    batch = pt.TrackTable(*(torch.stack(x) for x in zip(*alone)))
    alone = [pt.TrackTable(*(x.clone() for x in t)) for t in alone]
    levels, iou_solved, confirmed = [], 0, 0
    launches_alone = launches_batched = 0
    for frame in range(36):
        dets = [pt.pack_detections(cfg, *zip(*d), device="cpu") if d else
                pt.pack_detections(cfg, [], [], [], [], device="cpu")
                for d in (_stream_dets(k, w, r, frame)
                          for k, w, r in zip(kinds, worlds, rngs))]
        n = len(launches)
        outs, lv = [], []
        for i in range(S):
            m = len(stages)
            alone[i], out = pt.step(cfg, alone[i], dets[i])
            outs.append(out)
            lv.append(sum(d == cfg.max_cosine_distance for d in stages[m:]))
        levels.append(lv)
        launches_alone += len(launches) - n
        n, n_stages = len(launches), len(stages)
        batch, bout = pt.step(cfg, batch,
                              pt.Detections(*map(torch.stack, zip(*dets))))
        got = launches[n:]
        launches_batched += len(got)
        assert got == [S] * len(got)
        assert len(got) == len(stages) - n_stages
        iou = sum(d == cfg.max_iou_distance for d in stages[n_stages:])
        assert iou <= 1
        iou_solved += iou
        for i in range(S):
            for name in bout._fields:
                a, b = getattr(bout, name)[i], getattr(outs[i], name)
                if a.dtype.is_floating_point:
                    np.testing.assert_allclose(a.numpy(), b.numpy(),
                                               rtol=1e-5, atol=1e-5)
                else:
                    np.testing.assert_array_equal(
                        a.numpy(), b.numpy(),
                        err_msg=f"{mix} frame={frame} stream={i} {name}")
        for name in batch._fields:
            a = getattr(batch, name)
            for i in range(S):
                b = getattr(alone[i], name)
                if a.dtype.is_floating_point:
                    np.testing.assert_allclose(a[i].numpy(), b.numpy(),
                                               rtol=1e-5, atol=1e-5)
                else:
                    np.testing.assert_array_equal(a[i].numpy(), b.numpy())
        confirmed += int((bout.state == pt.CONFIRMED).sum())
    # tracks confirmed, some cascade solved two levels and the IoU stage ran
    assert confirmed > 0 and max(map(max, levels)) >= 2 and iou_solved > 0
    if S > 1:
        # the streams' cascades differ in depth at some frame
        assert any(len(set(lv)) > 1 for lv in levels)
        assert launches_batched < launches_alone
