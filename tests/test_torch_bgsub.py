"""deepdish_tpu_torch's MOG2 background subtraction and I420 conversion
against deepdish_tpu's, on the CPU, on the same numpy-made frames.

Bars: the masks agree on >= 0.999 of the pixels on every frame (the bar
tests/test_bgsub.py holds the JAX version to against cv2), every candidate
box gets the same motion-ratio decision, and the model's weight, mean and
var agree within atol 1e-4; the I420 conversion gives the same bytes on
>= 0.999 of the pixels and none more than 1 apart."""
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

from deepdish_tpu.ops import bgsub as jb
from deepdish_tpu.ops import colorspace as jc
from deepdish_tpu_torch.ops import bgsub as pb
from deepdish_tpu_torch.ops import colorspace as pc

H, W = 48, 64


def _scene(rng, n_frames=44):
    """A static textured background with noise; from frame 20 a bright
    object moves 2 px a frame; frame 0 has a pure-black corner."""
    base = rng.randint(40, 80, size=(H, W, 3)).astype(np.uint8)
    frames = []
    for i in range(n_frames):
        f = np.clip(base + rng.randint(-3, 4, size=base.shape), 0,
                    255).astype(np.uint8)
        if i >= 20:
            x = 4 + (i - 20) * 2
            f[10:30, x:x + 12] = 220
        frames.append(f)
    frames[0][:6, :6] = 0
    return frames


def _decisions(mask, boxes, ratio=0.25):
    fg = (np.asarray(mask) != 0).astype(np.int64)
    integral = np.pad(fg.cumsum(0).cumsum(1), ((1, 0), (1, 0)))
    return [bool(integral[y + h, x + w] - integral[y, x + w]
                 - integral[y + h, x] + integral[y, x] >= ratio * w * h)
            for (x, y, w, h) in boxes]


def test_update_matches_jax():
    rng = np.random.RandomState(0)
    frames = _scene(rng)
    js, ps = jb.init_state(H, W), pb.init_state(H, W, "cpu")
    decided = 0
    for i, f in enumerate(frames):
        js, jm = jb.update_jit(js, jnp.asarray(f))
        ps, pm = pb.update(ps, torch.from_numpy(f))
        jm, pm = np.asarray(jm), pm.numpy()
        assert pm.dtype == np.uint8
        agree = (jm == pm).mean()
        assert agree >= 0.999, f"frame {i}: masks agree on {agree}"
        sizes = rng.randint(1, 24, size=(12, 2))
        boxes = [(rng.randint(0, W - bw + 1), rng.randint(0, H - bh + 1),
                  int(bw), int(bh)) for bw, bh in sizes]
        if i >= 20:
            x = 4 + (i - 20) * 2
            boxes.append((x, 10, 12, 20))     # the moving object
        assert _decisions(pm, boxes) == _decisions(jm, boxes), f"frame {i}"
        decided += len(boxes)
        if i == 0:
            # cv2's frame-1 rule: every pixel shadow except pure black
            assert (pm[:6, :6] == 255).all()
            assert (pm[6:, 6:] == pb.SHADOW_VAL).all()
    assert decided > 500
    for name in ("weight", "mean", "var"):
        np.testing.assert_allclose(getattr(ps, name).numpy(),
                                   np.asarray(getattr(js, name)), atol=1e-4,
                                   err_msg=name)
    assert int(ps.frames) == int(js.frames) == len(frames)
    # the moving object is foreground on the last frame
    x = 4 + (len(frames) - 21) * 2
    assert (pm[10:30, x:x + 12] == 255).mean() > 0.7


def test_shadow_value_matches_jax():
    """Darkened background pixels come back 127, as in the JAX version."""
    base = np.full((32, 32, 3), 120, np.uint8)
    js, ps = jb.init_state(32, 32), pb.init_state(32, 32, "cpu")
    for _ in range(30):
        js, _ = jb.update_jit(js, jnp.asarray(base))
        ps, _ = pb.update(ps, torch.from_numpy(base))
    shadowed = base.copy()
    shadowed[8:16, 8:16] = 72          # 60% brightness, same chroma
    js, jm = jb.update_jit(js, jnp.asarray(shadowed))
    ps, pm = pb.update(ps, torch.from_numpy(shadowed))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    assert (pm.numpy()[8:16, 8:16] == pb.SHADOW_VAL).mean() > 0.8


def test_update_leaves_its_input_state_alone():
    rng = np.random.RandomState(1)
    state = pb.init_state(8, 8, "cpu")
    frame = torch.from_numpy(rng.randint(0, 256, (8, 8, 3)).astype(np.uint8))
    s1, _ = pb.update(state, frame)
    before = [t.clone() for t in s1]
    pb.update(s1, frame)
    for a, b in zip(s1, before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hw", [(120, 160), (240, 320), (720, 1280)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_yuv420_to_rgb_u8_matches_jax(hw):
    h, w = hw
    rng = np.random.RandomState(h)
    yuv = rng.randint(0, 256, (2, h * 3 // 2, w)).astype(np.uint8)
    want = np.asarray(jax.vmap(lambda f: jc.yuv420_to_rgb_u8(f, h, w))(
        jnp.asarray(yuv)))
    got = pc.yuv420_to_rgb_u8(torch.from_numpy(yuv), h, w).numpy()
    assert got.dtype == np.uint8 and got.shape == (2, h, w, 3)
    assert (got == want).mean() >= 0.999
    assert np.abs(got.astype(int) - want).max() <= 1
    single = pc.yuv420_to_rgb_u8(torch.from_numpy(yuv[0]), h, w).numpy()
    np.testing.assert_array_equal(single, got[0])


def test_sort_and_prefix_sum_pieces():
    """The re-sort's permutation is torch's stable descending sort on
    tie-heavy weights (zeros and repeats), and the prefix sum over the K
    components is bit-equal to the JAX version's jnp.cumsum."""
    rng = np.random.RandomState(3)
    w = rng.choice([0.0, 0.1, 0.25, 0.5], size=(4000, pb.K)).astype(
        np.float32)
    want = torch.sort(torch.from_numpy(w), dim=-1, descending=True,
                      stable=True)[1]
    assert torch.equal(pb._stable_desc_order(torch.from_numpy(w)), want)
    c = rng.rand(4000, pb.K).astype(np.float32)
    np.testing.assert_array_equal(
        pb._cumsum_k(torch.from_numpy(c)).numpy(),
        np.asarray(jnp.cumsum(jnp.asarray(c), axis=-1)))
