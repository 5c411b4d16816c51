"""Forward FLOPs of a convolutional model, counted from shapes by forward
hooks (the method of ``chip_smoke.py:conv_step_flop``, forward only)."""

from __future__ import annotations

import torch


def conv_forward_flop(model: torch.nn.Module, example: torch.Tensor) -> float:
    """Floating-point operations of the convolutions of one forward of
    ``example``: 2 x input channels x kernel area for every output element
    of every ``Conv2d`` (a multiply and an add a weight)."""
    total = [0]

    def hook(mod, inp, out):
        kh, kw = mod.kernel_size
        total[0] += 2 * out.numel() * (mod.in_channels // mod.groups) * kh * kw

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad():
            model(example)
    finally:
        for h in handles:
            h.remove()
    return float(total[0])


def disk_forward_flop(cfg: dict) -> float:
    """Forward FLOPs of one frame of DISK's U-Net at the configuration's
    size and widths: a k x k convolution per block, the down blocks at
    scales /1 ... /16 (input 3 channels, then the previous block's), the up
    blocks from /8 back to /1, each taking the previous block's channels and
    the skip of the down block of its scale; 2 x in x out x k^2 a pixel of
    the block's scale (about 644,000 a full-resolution pixel at the
    published widths)."""
    rows, cols, k = cfg["rows"], cfg["cols"], cfg["kernel_size"]
    down, up = cfg["down_channels"], cfg["up_channels"]
    total, cin = 0, 3
    for i, c in enumerate(down):
        total += 2 * cin * c * k * k * (rows >> i) * (cols >> i)
        cin = c
    for j, c in enumerate(up):
        scale = len(down) - 2 - j
        total += 2 * (cin + down[scale]) * c * k * k * (rows >> scale) * (cols >> scale)
        cin = c
    return float(total)
