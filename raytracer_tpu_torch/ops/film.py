"""Film: progressive accumulation buffer and display conversion
(src/dispatch.cu:111-152, src/main.cu:343-371)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def new_accumulator(num_pixels: int, device="cpu") -> torch.Tensor:
    return torch.zeros((num_pixels, 3), dtype=torch.float32, device=device)


def progressive_update(accum: torch.Tensor, frame_mean: torch.Tensor,
                       frame_num: int) -> torch.Tensor:
    """accum <- (mean + accum*frame_num) / (frame_num + 1), in place
    (src/raytracer.cu:109-113). Returns ``accum``."""
    fn = float(frame_num)
    return accum.mul_(fn).add_(frame_mean).div_(fn + 1.0)


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def to_u8(accum, width: int, height: int,
          gamma: Optional[float] = None) -> np.ndarray:
    """Float RGB -> (H, W, 3) u8, clamped and truncated like the reference
    (src/main.cu:343-371); ``gamma`` optionally corrects (quirk #8)."""
    if isinstance(accum, torch.Tensor):
        accum = accum.detach().cpu().numpy()
    img = np.asarray(accum).reshape(height, width, 3)
    if gamma is not None:
        img = np.power(np.clip(img, 0.0, None), 1.0 / gamma)
    return np.clip(img * 255.0, 0.0, 255.0).astype(np.uint8)
