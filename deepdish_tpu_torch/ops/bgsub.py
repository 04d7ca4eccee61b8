"""MOG2 background subtraction as a per-pixel Gaussian mixture in tensors.

Port of deepdish_tpu/ops/bgsub.py (`init_state` :51, `update` :59): the
equivalent of cv2.createBackgroundSubtractorMOG2 that the reference consumes
(deepdish.py:889,921-924). Zivkovic's adaptive mixture (up to K components a
pixel, weight pruning with the complexity-reduction prior, shadow detection)
is a fixed-shape (H, W, K) update of tensors on the state's device, so the
subtractor runs on the card beside the frame step, with no host read.

OpenCV's defaults: history 500 (learning rate 1 / min(2t, history)),
varThreshold Tb = 16, Tg = 9 for a new component, backgroundRatio 0.9,
varInit 15, varMin 4, varMax 75, CT 0.05, shadow value 127 with tau 0.5.
The mask is OpenCV's: 255 foreground, 127 shadow, 0 background.

The foreground decision is cv2's in-loop rule: the pixel is tested against
the components' pre-update means and variances, in the pre-update order,
gated by the cumulative post-update weights, so the first frame is all
foreground (no component existed) and a component inserted this frame never
votes for background on its own frame.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from ..device import resolve_device

K = 5            # nmixtures
TB = 16.0        # varThreshold (squared distance, 3 channels)
TG = 9.0         # varThresholdGen
BG_RATIO = 0.9   # backgroundRatio
VAR_INIT = 15.0
VAR_MIN = 4.0
VAR_MAX = 75.0
CT = 0.05
HISTORY = 500
SHADOW_TAU = 0.5
SHADOW_VAL = 127


class MOG2State(NamedTuple):
    weight: torch.Tensor   # (H, W, K) float32, sorted descending per pixel
    mean: torch.Tensor     # (H, W, K, 3) float32
    var: torch.Tensor      # (H, W, K) float32
    frames: torch.Tensor   # () int32, frames seen


def init_state(h: int, w: int,
               device: Optional[Union[str, torch.device]] = None
               ) -> MOG2State:
    """An empty model on `device` (default CUDA; raises without a card
    unless device="cpu")."""
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    return MOG2State(
        weight=torch.zeros((h, w, K), **f32),
        mean=torch.zeros((h, w, K, 3), **f32),
        var=torch.full((h, w, K), VAR_INIT, **f32),
        frames=torch.zeros((), dtype=torch.int32, device=dev))


def update(state: MOG2State, frame: torch.Tensor,
           detect_shadows: bool = True):
    """One frame (H, W, 3) uint8/float on the state's device ->
    (new_state, mask (H, W) uint8). The state passed in is not modified."""
    x = frame.float()
    w_, mu, var = state.weight, state.mean, state.var
    frames = state.frames + 1
    # cv2's auto learning rate is 1/min(2*nframes, history)
    # (BackgroundSubtractorMOG2Impl::apply)
    alpha = 1.0 / torch.clamp(2 * frames, max=HISTORY).float()

    diff = x[:, :, None, :] - mu                    # (H, W, K, 3)
    dist2 = (diff * diff).sum(-1)                   # (H, W, K)
    valid = w_ > 0.0

    # first (highest-weight) component that fits within Tg * var
    fits = valid & (dist2 < TG * var)
    kidx = torch.arange(K, device=x.device)
    first_fit = torch.where(fits, kidx, K).amin(-1)            # (H, W)
    any_fit = first_fit < K
    matched = kidx == first_fit[..., None]                      # (H, W, K)

    # weight update with the pruning prior
    w_new = (1.0 - alpha) * w_ - alpha * CT
    w_new = torch.where(matched, w_new + alpha, w_new)
    dropped = w_new <= 0.0
    w_new = torch.where(dropped, 0.0, w_new)

    # the matched component's mean and variance
    kfac = torch.where(matched & ~dropped,
                       alpha / torch.clamp(w_new, min=1e-8), 0.0)
    mu_new = mu + kfac[..., None] * diff
    var_new = torch.clamp(var + kfac * (dist2 - var), VAR_MIN, VAR_MAX)

    # ---- foreground decision: cv2's in-loop rule ----
    # old sort order and old means/variances; a component may vote for
    # background only while the cumulative UPDATED weight of the components
    # before it is below backgroundRatio; new components are excluded
    cum_before_old = _cumsum_k(w_new) - w_new
    may_vote = valid & (cum_before_old < BG_RATIO)
    background = (may_vote & (dist2 < TB * var)).any(-1)

    mask = torch.where(background, 0, 255).to(torch.uint8)

    if detect_shadows:
        # chromatic shadow test against the pre-update background
        # components: brightness ratio in [tau, 1], low color distortion
        mm = (mu * mu).sum(-1)                                  # (H, W, K)
        xm = (x[:, :, None, :] * mu).sum(-1)
        ratio = xm / torch.clamp(mm, min=1e-8)
        cdiff = x[:, :, None, :] - ratio[..., None] * mu
        cdist2 = (cdiff * cdiff).sum(-1)
        shadow_fit = (may_vote & (ratio >= SHADOW_TAU) & (ratio <= 1.0)
                      & (cdist2 < TB * var))
        is_shadow = ~background & shadow_fit.any(-1)
        # cv2 quirk: on the first frame the shadow test runs against the
        # component just made from the pixel itself (ratio 1 -> shadow),
        # so every pixel comes back 127 EXCEPT pure black, where
        # detectShadowGMM's division-by-zero guard returns foreground (255)
        first_frame_shadow = (state.frames == 0) & ((x * x).sum(-1) > 0.0)
        is_shadow = is_shadow | first_frame_shadow
        mask = torch.where(is_shadow, SHADOW_VAL, mask).to(torch.uint8)

    # no fit -> a new component in the weakest slot (K - 1; list is sorted)
    new_slot = ~any_fit[..., None] & (kidx == K - 1)            # (H, W, K)
    w_new = torch.where(new_slot, alpha, w_new)
    mu_new = torch.where(new_slot[..., None], x[:, :, None, :], mu_new)
    var_new = torch.where(new_slot, VAR_INIT, var_new)

    # normalize and re-sort by weight, descending and stable (zero weights
    # keep their order, as JAX's stable argsort of -w keeps its -0.0 ties)
    total = w_new.sum(-1, keepdim=True)
    w_new = w_new / torch.clamp(total, min=1e-8)
    order = _stable_desc_order(w_new)
    w_new = w_new.gather(-1, order)
    mu_new = mu_new.gather(-2, order[..., None].expand(mu_new.shape))
    var_new = var_new.gather(-1, order)
    return MOG2State(weight=w_new, mean=mu_new, var=var_new,
                     frames=frames), mask


def _cumsum_k(w: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the K components: float32 adds left to
    right, bit-equal to the JAX version's jnp.cumsum on the CPU
    (torch.cumsum accumulates in float64 there, and on the card runs a
    scan kernel that took most of a 720p frame's bgsub time)."""
    parts = [w[..., 0]]
    for k in range(1, K):
        parts.append(parts[-1] + w[..., k])
    return torch.stack(parts, -1)


def _stable_desc_order(w: torch.Tensor) -> torch.Tensor:
    """The permutation of a stable descending sort over the last dim
    (torch.sort(w, descending=True, stable=True)'s indices, which is
    unique): component i goes to rank #{j: w_j > w_i} + #{j < i: w_j ==
    w_i}. K x K compares in place of a segmented radix sort."""
    wi, wj = w[..., :, None], w[..., None, :]
    earlier = torch.ones((K, K), dtype=torch.bool,
                         device=w.device).tril(-1)      # [i, j]: j < i
    rank = ((wj > wi) | ((wj == wi) & earlier)).sum(-1)
    kidx = torch.arange(K, device=w.device).expand(w.shape)
    return torch.empty_like(rank).scatter_(-1, rank, kidx)
