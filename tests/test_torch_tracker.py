"""Port parity of tracker.step: deepdish_tpu_torch (plain LSAP on the CPU)
against deepdish_tpu (JAX on the CPU) frame by frame on randomised
detection streams. Ids, states, matched detections, deletions, hits, ages
and label votes are integers and must match exactly; boxes and the gallery
are float32 with a stated tolerance. The small gallery (G = 16) makes the
ring wrap, so the ring write is covered too."""
import pytest

jax = pytest.importorskip("jax")  # the reference side needs JAX

import numpy as np
import torch

from deepdish_tpu import tracker as jt
from deepdish_tpu_torch import tracker as pt

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
