"""Image pyramids: 5x5 binomial downsample with uint8 requantization.

Replaces Pyramid_class::make_pyramid (pyramid_class.cpp:83-126) and the CUDA
pyramid kernels (kernels.cu:761-918) with a strided `lax.conv`.

Reference semantics preserved:
  * separable 5x5 kernel, outer product of [.05, .25, .4, .25, .05]
    (pyramid_class.cpp:83-90),
  * each level is half the previous (integer division of dims),
  * target pixel (ti, tj) averages the 5x5 source window centered at
    (2*ti, 2*tj); the one-pixel border of every level is zero,
  * every level is requantized to uint8 by truncation toward zero
    ((unsigned char)addition at pyramid_class.cpp:118-119) — the next level
    is built from the *quantized* previous level.

The weights are the integers [1, 5, 8, 5, 1] / 20, so each target is an
integer sum (below 255 * 400 < 2^24, exact in float32 whatever order the
convolution sums in) divided by 400 and truncated in integer arithmetic:
the level is exact on every backend.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

BINOMIAL_INT = np.array([1, 5, 8, 5, 1], np.int32)  # sums to 20
BINOMIAL_1D = (BINOMIAL_INT / 20.0).astype(np.float32)


def _downsample_once(image: jax.Array) -> jax.Array:
    """One pyramid level: [H, W, C] -> [H//2, W//2, C] (float32, uint8-valued)."""
    h, w, c = image.shape
    th, tw = h // 2, w // 2
    kernel = np.outer(BINOMIAL_INT, BINOMIAL_INT).astype(np.float32)
    filters = jnp.asarray(kernel)[:, :, None, None]  # HWIO, depthwise
    if c > 1:
        filters = jnp.tile(filters, (1, 1, 1, c))
    # VALID conv, stride 2: output t corresponds to source center 2t + 2,
    # i.e. target index tj = t + 1; interior targets are 1 .. th-2.
    core = jax.lax.conv_general_dilated(
        image[None],
        filters,
        window_strides=(2, 2),
        padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=c,
        precision=jax.lax.Precision.HIGHEST,
    )[0]
    # Integer sum // 400 == floor(weighted mean), the uint8 truncation;
    # round() only guards against a convolution algorithm that is not
    # exact on integers.
    core = jnp.round(core[: th - 2, : tw - 2]).astype(jnp.int32) // 400
    core = core.astype(jnp.float32)
    out = jnp.zeros((th, tw, c), jnp.float32)
    return out.at[1 : th - 1, 1 : tw - 1].set(core)


def build_pyramid(image: jax.Array, num_levels: int) -> list[jax.Array]:
    """Build levels 0..num_levels (inclusive) of the image pyramid.

    Args:
      image: [H, W, C] float32 with integer (uint8) values; level 0.
      num_levels: the highest (coarsest) level index ("pyramid stop").

    Returns:
      List of num_levels + 1 arrays; level l has shape [H >> l-ish, ...]
      (integer halving per level, like pyramid_class.cpp:93-96).
    """
    levels = [image]
    for _ in range(num_levels):
        levels.append(_downsample_once(levels[-1]))
    return levels
