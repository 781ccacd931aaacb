"""Host-side color helpers for the 8-bit ingest path (the port's copy of
the JAX package's io/color.py)."""
import numpy as np


def linear_to_srgb_u8(img: np.ndarray) -> np.ndarray:
    """[3, H, W] linear sRGB floats -> sRGB-encoded u8 (IEC 61966-2-1 OETF).

    Inverse of the device-side linearization in
    ops.pipeline.extract_groups_device. Out-of-gamut values clip."""
    x = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    srgb = np.where(
        x <= 0.0031308, x * 12.92, 1.055 * np.power(x, 1.0 / 2.4) - 0.055
    )
    return np.clip(srgb * 255.0 + 0.5, 0, 255).astype(np.uint8)


def srgb_u8_to_linear(u8: np.ndarray) -> np.ndarray:
    """Numpy twin of the device linearization (for tests)."""
    x = np.asarray(u8, np.float32) / 255.0
    return np.where(
        x <= 0.04045, x / 12.92, np.power((x + 0.055) / 1.055, 2.4)
    ).astype(np.float32)
