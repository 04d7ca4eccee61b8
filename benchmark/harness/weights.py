"""Weights from the seed, made on the device, and their batch norms
calibrated on the walker scene.

Every convolution and dense kernel is flax's default draw (lecun normal:
a normal of std sqrt(1 / fan_in) / 0.8796, truncated at two stds), biases
are zero and batch norms start as the identity; then each batch norm's
statistics are set to those of its input on a few images (`calibrate`), so
that activations neither vanish nor explode through a deep random net. A
frozen rewrite of the port's `models/layers.flax_default_init_` and of
`chip_smoke._calibrated_init`: all kernels of a net come from one draw of
one generator on the device, as a truncated normal by the inverse CDF.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from reference.layers import BatchNorm

from .scene import seed_int

_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))   # Phi(-2)
_HI = 1.0 - _LO


def draw(net: nn.Module, seed: int, salt: int) -> None:
    """Flax's default draw into every conv / dense kernel of `net` (on its
    device), zero biases, identity batch norms."""
    kernels = [m for m in net.modules()
               if isinstance(m, (nn.Conv2d, nn.Linear))]
    dev = kernels[0].weight.device
    total = sum(m.weight.numel() for m in kernels)
    g = torch.Generator(device=dev).manual_seed(seed_int(seed, salt))
    u = torch.empty(total, device=dev).uniform_(_LO, _HI, generator=g)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    at = 0
    with torch.no_grad():
        for m in kernels:
            n = m.weight.numel()
            std = math.sqrt(1.0 / m.weight[0].numel()) / 0.87962566103423978
            m.weight.copy_(z[at:at + n].view_as(m.weight) * std)
            at += n
            if m.bias is not None:
                m.bias.zero_()
        for m in net.modules():
            if isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)


def calibrate(net: nn.Module, images: torch.Tensor,
              shift: float = 0.0) -> None:
    """Each batch norm's statistics set to those of its input on `images`
    (one forward of `net`), and its bias to `shift`.

    A shift keeps most units of the following ReLUs active. A random ReLU
    net with calibrated batch norms and no shift is chaotic, as no trained
    detector is: a rounding in bf16 grows by 1.1-1.2x a layer, to 50-100%
    of the outputs' RMS at the heads of SSD-MobileNetV1 and of Faster
    R-CNN's RPN, so no tolerance could tell bf16 from a lower precision."""
    def set_stats(bn, args):
        x = args[0]
        dims = (0, 2, 3) if x.dim() == 4 else (0,)
        bn.running_mean.copy_(x.mean(dims))
        bn.running_var.copy_(x.var(dims, unbiased=False))
        bn.bias.fill_(shift)

    hooks = [m.register_forward_pre_hook(set_stats)
             for m in net.modules() if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            net(images)
    finally:
        for h in hooks:
            h.remove()


def noise_images(n: int, h: int, w: int, seed: int, salt: int,
                 device) -> torch.Tensor:
    """(n, h, w, 3) float32 uniform integers 0..255 from the seed."""
    g = torch.Generator(device=device).manual_seed(seed_int(seed, salt))
    return torch.randint(0, 256, (n, h, w, 3), generator=g, device=device,
                         dtype=torch.int32).float()


def served(net: nn.Module, dtype: torch.dtype) -> dict:
    """The net's state dict in the type it is served in (floating leaves
    cast to `dtype`)."""
    return {k: (v.detach().to(dtype) if v.is_floating_point() else
                v.detach()) for k, v in net.state_dict().items()}


def make_mars(seed: int, device, scene_rgb, dtype):
    """(served state dict, float32 reference MARS net holding the same
    values): flax's draw from the seed, batch norms calibrated on
    `scene_rgb` resized to 128 x 64 and two noise images (unshifted:
    MARS is shallow, and its bf16 features stay within 2% of float32)."""
    from reference.mars import INPUT_SHAPE, MarsNet
    from reference.preprocess import resize_bilinear_mxu
    h, w = INPUT_SHAPE[:2]
    with torch.device(device):
        net = MarsNet().eval()
    draw(net, seed, salt=5)
    calibrate(net, torch.cat([
        resize_bilinear_mxu(scene_rgb, h, w, torch.float32),
        noise_images(2, h, w, seed, 6, device)]))
    sd = served(net, dtype)
    net.load_state_dict(sd)
    net.requires_grad_(False)
    return sd, net


def calibration_frames(tr: dict, waves: torch.Tensor) -> torch.Tensor:
    """Two frames of `waves` (one wave of the unrolled scene) with the
    walkers in view ((2, H, W, 3) uint8): the calibration's images besides
    noise, as the port's `chip_smoke._calibration_images` takes them."""
    from .scene import period
    nb, P = int(tr["background_frames"]), period(tr)
    return waves[[min(nb + 4, P - 1), min(nb + P // 2, P - 1)]]
