"""Automatic initial-guess seeding by phase correlation.

The reference's initial-guess modes are {Null, Auto, User}
(enums.hpp:41): Null = zeros, User = GUI-edited parameters, Auto = a
per-model archive of previously used guesses (mainapp.cpp:1692-1736) —
i.e. the user still supplies the first value.  A headless framework needs
a real automatic mode: LM correlation only converges when the initial
guess lands within the pyramid's capture range (a few pixels at the
coarsest level), so large rigid displacements need seeding.

This module estimates integer translation by FFT phase correlation — the
standard DIC seeding technique — batched over sectors on the device's
FFT:

    R = F(und) * conj(F(def)) / |...|   (cross-power spectrum)
    r = F^-1(R); (du, dv) = argmax r    (correlation peak)

The peak gives the whole-pixel translation from the undeformed to the
deformed window; the LM solver refines to sub-pixel from there.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnums=(2,))
def _phase_correlate(und_w: jax.Array, def_w: jax.Array, win: int):
    """Batched phase correlation of [S, win, win] window pairs.

    Returns [S, 2] (du, dv) integer translations (float32).
    """
    # Hann window damps the periodic-boundary ringing of the FFT.
    n = jnp.arange(win, dtype=jnp.float32)
    hann = 0.5 - 0.5 * jnp.cos(2.0 * jnp.pi * n / win)
    taper = hann[:, None] * hann[None, :]

    def prep(w):
        w = w - jnp.mean(w, axis=(-2, -1), keepdims=True)
        return w * taper

    fu = jnp.fft.rfft2(prep(und_w))
    fd = jnp.fft.rfft2(prep(def_w))
    cross = fu * jnp.conj(fd)
    cross = cross / jnp.maximum(jnp.abs(cross), 1e-9)
    corr = jnp.fft.irfft2(cross, s=(win, win))  # [S, win, win]

    flat = corr.reshape(corr.shape[0], -1)
    idx = jnp.argmax(flat, axis=-1)
    py = (idx // win).astype(jnp.int32)
    px = (idx % win).astype(jnp.int32)
    # F(und)conj(F(def)) peaks at the cyclic shift taking def back to und;
    # the und->def displacement (u, v) is its negation, unwrapped to the
    # smallest signed magnitude.
    du = -jnp.where(px > win // 2, px - win, px)
    dv = -jnp.where(py > win // 2, py - win, py)
    return jnp.stack([du, dv], axis=-1).astype(jnp.float32)


def _windows(img: np.ndarray, centers: np.ndarray, win: int) -> np.ndarray:
    h, w = img.shape[:2]
    half = win // 2
    out = np.zeros((len(centers), win, win), np.float32)
    for i, (cx, cy) in enumerate(centers):
        x0 = int(np.clip(round(cx) - half, 0, max(w - win, 0)))
        y0 = int(np.clip(round(cy) - half, 0, max(h - win, 0)))
        out[i] = img[y0 : y0 + win, x0 : x0 + win, 0]
    return out


def phase_correlation_guess(
    und: np.ndarray,
    dfm: np.ndarray,
    centers: np.ndarray,
    win: int = 64,
) -> np.ndarray:
    """Per-sector whole-pixel (u, v) seeds from windows around `centers`.

    Args:
      und, dfm: [H, W, C] float32 images (channel 0 is used).
      centers: [S, 2] sector centers (x, y).
      win: correlation window size (power of two; clipped to the image).

    Returns:
      [S, 2] float32 integer-valued (u, v) displacement seeds.
    """
    und = np.asarray(und)
    dfm = np.asarray(dfm)
    centers = np.asarray(centers, np.float32).reshape(-1, 2)
    win = int(min(win, und.shape[0], und.shape[1]))
    uw = _windows(und, centers, win)
    dw = _windows(dfm, centers, win)
    return np.asarray(_phase_correlate(jnp.asarray(uw), jnp.asarray(dw), win))


def global_guess_from_pair(
    und: np.ndarray,
    dfm: np.ndarray,
    center: np.ndarray,
    num_params: int,
    win: int = 128,
) -> np.ndarray:
    """One global [NP] guess (u, v filled, higher-order terms zero) for the
    frame-0 solve — the headless automatic analog of the reference's
    initial-guess selection."""
    uv = phase_correlation_guess(und, dfm, np.asarray(center).reshape(1, 2),
                                 win=win)[0]
    guess = np.zeros(num_params, np.float32)
    guess[0] = uv[0]
    if num_params > 1:
        guess[1] = uv[1]
    return guess
