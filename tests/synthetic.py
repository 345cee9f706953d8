"""Synthetic speckle images with analytically warpable intensity fields.

und(x, y) = f(x, y) and def(z) = f(T^{-1}(z)) so the forward warp T maps
undeformed pixels onto the deformed image exactly: und(x) == def(T(x)).
"""

from __future__ import annotations

import numpy as np


class Speckle:
    """Sum-of-Gaussians speckle field (classic DIC synthetic texture)."""

    def __init__(self, h: int, w: int, seed: int = 0, density: float = 0.02):
        rng = np.random.default_rng(seed)
        n = max(int(h * w * density), 8)
        self.cx = rng.uniform(0, w, n)
        self.cy = rng.uniform(0, h, n)
        self.amp = rng.uniform(60, 200, n)
        self.sig = rng.uniform(1.8, 4.0, n)
        self.h, self.w = h, w

    def eval(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        out = np.full(np.shape(x), 20.0)
        for cx, cy, a, s in zip(self.cx, self.cy, self.amp, self.sig):
            out = out + a * np.exp(
                -((x - cx) ** 2 + (y - cy) ** 2) / (2 * s * s)
            )
        return np.clip(out, 0.0, 255.0)

    def image(self, quantize: bool = False) -> np.ndarray:
        gy, gx = np.mgrid[0 : self.h, 0 : self.w]
        img = self.eval(gx, gy)
        if quantize:
            img = np.floor(img)
        return img.astype(np.float32)

    def shifted_image(
        self,
        u: float = 0.0,
        v: float = 0.0,
        quantize: bool = False,
        cutoff: float = 5.0,
    ) -> np.ndarray:
        """Translated image def(z) = f(z - (u, v)), rendered fast.

        Each Gaussian is evaluated only on the pixels within cutoff*sigma
        of its centre in x and in y (a cut below 200*exp(-cutoff^2/2)
        grey levels: 7.5e-4 at 5), so megapixel frames render in about a
        second instead of minutes.  The cut field is itself exactly
        translated, so und(x) == def(x + (u, v)) still holds.
        """
        h, w = self.h, self.w
        cx = self.cx + u
        cy = self.cy + v
        r = int(np.ceil(cutoff * self.sig.max()))
        offs = np.arange(-r, r + 1)
        acc = np.zeros(h * w)
        for lo in range(0, len(cx), 2048):
            sl = slice(lo, lo + 2048)
            xs = np.floor(cx[sl])[:, None] + offs  # [n, 2r+1]
            ys = np.floor(cy[sl])[:, None] + offs
            s2 = (2.0 * self.sig[sl] ** 2)[:, None]
            dx = xs - cx[sl][:, None]
            dy = ys - cy[sl][:, None]
            lim = (cutoff * self.sig[sl])[:, None]
            gx = np.where(
                (np.abs(dx) <= lim) & (xs >= 0) & (xs < w),
                np.exp(-dx * dx / s2), 0.0,
            )
            gy = np.where(
                (np.abs(dy) <= lim) & (ys >= 0) & (ys < h),
                self.amp[sl][:, None] * np.exp(-dy * dy / s2), 0.0,
            )
            vals = gy[:, :, None] * gx[:, None, :]
            idx = (
                np.clip(ys, 0, h - 1)[:, :, None] * w
                + np.clip(xs, 0, w - 1)[:, None, :]
            ).astype(np.int64)
            acc += np.bincount(
                idx.ravel(), weights=vals.ravel(), minlength=h * w
            )
        img = np.clip(acc.reshape(h, w) + 20.0, 0.0, 255.0)
        if quantize:
            img = np.floor(img)
        return img.astype(np.float32)

    def warped_image(
        self,
        u: float = 0.0,
        v: float = 0.0,
        affine: np.ndarray | None = None,
        center: tuple[float, float] = (0.0, 0.0),
        quantize: bool = False,
    ) -> np.ndarray:
        """Deformed image for forward warp T(x) = x + (u,v) + M (x - c).

        def(z) = f(T^{-1}(z)).
        """
        gy, gx = np.mgrid[0 : self.h, 0 : self.w]
        if affine is None:
            sx = gx - u
            sy = gy - v
        else:
            m = np.eye(2) + np.asarray(affine, np.float64)
            minv = np.linalg.inv(m)
            cx, cy = center
            zx = gx - cx - u
            zy = gy - cy - v
            sx = cx + minv[0, 0] * zx + minv[0, 1] * zy
            sy = cy + minv[1, 0] * zx + minv[1, 1] * zy
        img = self.eval(sx, sy)
        if quantize:
            img = np.floor(img)
        return img.astype(np.float32)


class FourierTexture:
    """Band-limited random trigonometric field — exactly warpable like
    Speckle but O(n_waves) per point, so large benchmark images are cheap.

    f(x, y) = bias + sum_k a_k sin(kx_k x + ky_k y + phi_k)
    """

    def __init__(self, h: int, w: int, seed: int = 0, n_waves: int = 64,
                 max_freq: float = 0.12):
        rng = np.random.default_rng(seed)
        ang = rng.uniform(0, 2 * np.pi, n_waves)
        # cycles/pixel kept far below Nyquist so bicubic interpolation can
        # represent the field accurately (like the reference's speckle)
        mag = rng.uniform(0.02, max_freq, n_waves) * 2 * np.pi
        self.kx = (mag * np.cos(ang)).astype(np.float64)
        self.ky = (mag * np.sin(ang)).astype(np.float64)
        self.phi = rng.uniform(0, 2 * np.pi, n_waves)
        amp = rng.uniform(0.5, 1.0, n_waves)
        # rms contrast ~= 35 gray levels; peaks stay inside [0, 255] so the
        # clip never kinks the field (kinks break bicubic representability)
        amp = amp * (35.0 / np.sqrt(np.sum(amp**2) / 2.0))
        self.amp = amp
        self.h, self.w = h, w

    def eval(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        xf = np.asarray(x, np.float64)[..., None]
        yf = np.asarray(y, np.float64)[..., None]
        out = 127.0 + np.sum(
            self.amp * np.sin(xf * self.kx + yf * self.ky + self.phi),
            axis=-1,
        )
        return np.clip(out, 0.0, 255.0)

    image = Speckle.image
    warped_image = Speckle.warped_image
