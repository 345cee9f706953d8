"""Independent NumPy oracle of the reference algorithm for parity tests.

A direct, scalar (loop-based, float64) implementation of the math specified
by the reference — warp models (model_class.cpp:48-202), finite-difference
constrained bicubic interpolation (interpolation_class.cpp:79-138, 243-336),
normal-equation assembly (interpolation_class.cpp:671-764), and the
LM-damped Gauss-Newton loop with the saved-parameter optimization
(correlation_class.cpp:349-640).

Deliberately written independently of correlation_jax internals (its own
constraint construction, its own linear solves) so that agreement between the
two is a meaningful check.
"""

from __future__ import annotations

import numpy as np

FLT_MAX = float(np.finfo(np.float32).max)


# ---------------------------------------------------------------------------
# Warp models
# ---------------------------------------------------------------------------


def warp(model: str, p, x, y, cx, cy, positions: str = "float64"):
    """Warped position of (x, y).  positions="float64" evaluates in
    float64; "float32" / "float32_fma" reproduce a float32 device's
    rounding of the same formula, left to right, each product rounded
    or fused into the following add.  Nearest sampling is discontinuous
    at half pixels, so only a position rounded like the device's rounds
    to the same pixel when a sample lands within float32 resolution
    (6e-5 px at x ~ 1000) of a boundary."""
    if positions != "float64":
        return _warp_f32(model, p, x, y, cx, cy, positions == "float32_fma")
    if model == "U":
        return x + p[0], y
    if model == "UV":
        return x + p[0], y + p[1]
    dx, dy = x - cx, y - cy
    if model == "UVQ":
        return x + p[0] - p[2] * dy, y + p[1] + p[2] * dx
    if model == "AFFINE":
        return (
            x + p[0] + p[2] * dx + p[3] * dy,
            y + p[1] + p[4] * dx + p[5] * dy,
        )
    raise ValueError(model)


def _warp_f32(model, p, x, y, cx, cy, fma: bool):
    f = np.float32
    p = [f(v) for v in p]
    x, y = f(x), f(y)

    def mul_add(a, b, c):  # a * b + c
        if fma:
            return f(float(a) * float(b) + float(c))
        return f(a * b) + c

    if model == "U":
        return float(x + p[0]), float(y)
    if model == "UV":
        return float(x + p[0]), float(y + p[1])
    dx, dy = x - f(cx), y - f(cy)
    if model == "UVQ":
        return (float(mul_add(-p[2], dy, x + p[0])),
                float(mul_add(p[2], dx, y + p[1])))
    if model == "AFFINE":
        return (float(mul_add(p[3], dy, mul_add(p[2], dx, x + p[0]))),
                float(mul_add(p[5], dy, mul_add(p[4], dx, y + p[1]))))
    raise ValueError(model)


def jacobian(model: str, x, y, cx, cy):
    """(dTx/dp, dTy/dp) rows."""
    dx, dy = x - cx, y - cy
    if model == "U":
        return np.array([1.0]), np.array([0.0])
    if model == "UV":
        return np.array([1.0, 0.0]), np.array([0.0, 1.0])
    if model == "UVQ":
        return np.array([1.0, 0.0, -dy]), np.array([0.0, 1.0, dx])
    if model == "AFFINE":
        return (
            np.array([1.0, 0.0, dx, dy, 0.0, 0.0]),
            np.array([0.0, 1.0, 0.0, 0.0, dx, dy]),
        )
    raise ValueError(model)


NP_OF = {"U": 1, "UV": 2, "UVQ": 3, "AFFINE": 6}


# ---------------------------------------------------------------------------
# Bicubic interpolation (independent construction)
# ---------------------------------------------------------------------------


def _constraint_matrix():
    """Rows: value/dx/dy/dxy constraints at (x,y) in {1,2}^2; columns:
    coefficients of y^j x^i, flat index 4*j + i."""
    pts = [(1, 1), (2, 1), (1, 2), (2, 2)]
    mat = np.zeros((16, 16))
    for r, (x, y) in enumerate(pts):
        for j in range(4):
            for i in range(4):
                mat[r, 4 * j + i] = y**j * x**i
                if i >= 1:
                    mat[4 + r, 4 * j + i] = i * y**j * x ** (i - 1)
                if j >= 1:
                    mat[8 + r, 4 * j + i] = j * y ** (j - 1) * x**i
                if i >= 1 and j >= 1:
                    mat[12 + r, 4 * j + i] = (
                        i * j * y ** (j - 1) * x ** (i - 1)
                    )
    return mat


_CMAT = _constraint_matrix()


def bicubic_coeffs(img: np.ndarray, ix: int, iy: int) -> np.ndarray:
    """Solve the 16-coefficient system for anchor pixel (ix, iy).

    img: [H, W] float.  Constraint vector per
    interpolation_class.cpp:296-321 (w<X><Y>: X = column, Y = row).
    """
    win = img[iy - 1 : iy + 3, ix - 1 : ix + 3].astype(np.float64)

    def w(x, y):
        return win[y, x]

    vec = np.array(
        [
            w(1, 1),
            w(2, 1),
            w(1, 2),
            w(2, 2),
            (w(2, 1) - w(0, 1)) / 2,
            (w(3, 1) - w(1, 1)) / 2,
            (w(2, 2) - w(0, 2)) / 2,
            (w(3, 2) - w(1, 2)) / 2,
            (w(1, 2) - w(1, 0)) / 2,
            (w(2, 2) - w(2, 0)) / 2,
            (w(1, 3) - w(1, 1)) / 2,
            (w(2, 3) - w(2, 1)) / 2,
            (w(2, 2) + w(0, 0) - w(2, 0) - w(0, 2)) / 4,
            (w(3, 2) + w(1, 0) - w(3, 0) - w(1, 2)) / 4,
            (w(2, 3) + w(0, 1) - w(2, 1) - w(0, 3)) / 4,
            (w(3, 3) + w(1, 1) - w(3, 1) - w(1, 3)) / 4,
        ]
    )
    return np.linalg.solve(_CMAT, vec)


def interp_bicubic(img: np.ndarray, xdef: float, ydef: float):
    """Returns (w, dwdx, dwdy, valid), interpolation_class.cpp:79-138."""
    h, w_ = img.shape
    if not (1.0 < xdef < w_ - 2.0 and 1.0 < ydef < h - 2.0):
        return 0.0, 0.0, 0.0, False
    ix, iy = int(xdef), int(ydef)
    a = bicubic_coeffs(img, ix, iy)
    dx = xdef - ix + 1.0
    dy = ydef - iy + 1.0
    px = [1.0, dx, dx * dx, dx**3]
    py = [1.0, dy, dy * dy, dy**3]
    wv = dwdx = dwdy = 0.0
    for j in range(4):
        for i in range(4):
            c = a[4 * j + i]
            wv += c * py[j] * px[i]
            if i > 0:
                dwdx += i * c * py[j] * px[i - 1]
            if j > 0:
                dwdy += j * c * py[j - 1] * px[i]
    return wv, dwdx, dwdy, True


def interp_bilinear(img, xdef, ydef):
    h, w_ = img.shape
    if not (0.0 < xdef < w_ - 1.0 and 0.0 < ydef < h - 1.0):
        return 0.0, 0.0, 0.0, False
    ix, iy = int(xdef), int(ydef)
    w00 = float(img[iy, ix])
    w10 = float(img[iy, ix + 1])
    w01 = float(img[iy + 1, ix])
    w11 = float(img[iy + 1, ix + 1])
    a = [w00, w10 - w00, w01 - w00, w11 - w10 - w01 + w00]
    dx, dy = xdef - ix, ydef - iy
    wv = a[0] + a[1] * dx + a[2] * dy + a[3] * dx * dy
    return wv, a[1] + a[3] * dy, a[2] + a[3] * dx, True


def interp_nearest(img, xdef, ydef):
    h, w_ = img.shape
    if not (0.0 < xdef < w_ - 1.0 and 0.0 < ydef < h - 1.0):
        return 0.0, 0.0, 0.0, False
    ix, iy = int(xdef + 0.5), int(ydef + 0.5)
    ix = min(ix, w_ - 2)
    iy = min(iy, h - 2)
    w00 = float(img[iy, ix])
    return w00, float(img[iy, ix + 1]) - w00, float(img[iy + 1, ix]) - w00, True


INTERP = {
    "nearest": interp_nearest,
    "bilinear": interp_bilinear,
    "bicubic": interp_bicubic,
}


# ---------------------------------------------------------------------------
# Assembly + LM loop
# ---------------------------------------------------------------------------


def assemble(model, interp, und_img, def_img, pts, cx, cy, params,
             positions="float64"):
    """Serial A/b/chi assembly (interpolation_class.cpp:671-764).

    pts: [P, 2] float level coordinates.  Returns (A, b, chi, error).
    positions: arithmetic of the warped positions (see warp).
    """
    num_p = NP_OF[model]
    a_mat = np.zeros((num_p, num_p))
    b_vec = np.zeros(num_p)
    chi = 0.0
    error = False
    h_img, w_img = und_img.shape
    fn = INTERP[interp]
    for x, y in pts:
        xd, yd = warp(model, params, x, y, cx, cy, positions)
        wv, dwdx, dwdy, valid = fn(def_img, xd, yd)
        if not valid:
            error = True
        und_ix = min(max(int(x + 0.5), 0), w_img - 1)
        und_iy = min(max(int(y + 0.5), 0), h_img - 1)
        und_w = float(und_img[und_iy, und_ix])
        v = und_w - wv
        chi += v * v
        jx, jy = jacobian(model, x, y, cx, cy)
        h_vec = dwdx * jx + dwdy * jy
        b_vec += h_vec * v
        a_mat += np.outer(h_vec, h_vec)
    return a_mat, b_vec, chi, error


def lm_update(a_mat, b_vec, lam, scaling, params):
    a = a_mat * scaling
    b = b_vec * scaling
    a = a + np.diag(np.diag(a)) * lam
    dp = np.linalg.solve(a, b)
    return params + dp


def decimate(pts, level):
    mag = 1 << level
    out = []
    for x, y in pts:
        if int(x + 0.5) % mag == 0 and int(y + 0.5) % mag == 0:
            out.append((x / mag, y / mag))
    return np.array(out).reshape(-1, 2)


def newton_raphson(
    model,
    interp,
    und_pyramid,
    def_pyramid,
    pts0,
    params0,
    center0=None,
    levels=(2, 1, 0),
    max_iters=50,
    precision=1e-3,
    positions="float64",
):
    """Full coarse-to-fine LM solve for ONE subset
    (correlation_class.cpp:349-640).

    und_pyramid/def_pyramid: lists of [H, W] float images (level index).
    positions: arithmetic of the warped positions (see warp).
    Returns dict(params, chi, iterations, error).
    """
    p = np.array(params0, np.float64)
    if center0 is None:
        center0 = pts0.mean(axis=0)
    reached = 0
    error = None
    last_good_chi = FLT_MAX

    prev_level = 0
    for level in levels:
        # translate u, v
        mag = 2.0 ** (prev_level - level)
        p[: min(2, len(p))] *= mag
        prev_level = level

        pts = decimate(pts0, level)
        cx, cy = center0[0] / (1 << level), center0[1] / (1 << level)
        n = len(pts)
        if n == 0:
            return dict(params=p, chi=FLT_MAX, iterations=reached,
                        error="bad_domain")
        scaling = 1.0 / n
        lam = 1e-4
        last_good_chi = FLT_MAX
        error = None

        und_img = und_pyramid[level]
        def_img = def_pyramid[level]

        a_mat, b_vec, chi, err = assemble(
            model, interp, und_img, def_img, pts, cx, cy, p, positions
        )
        if err:
            p[: min(2, len(p))] *= 2.0 ** (level - 0)
            return dict(
                params=p, chi=FLT_MAX, iterations=reached,
                error="interp_out_of_image",
            )
        chi *= scaling
        last_good_chi = chi
        last_good = p.copy()
        p = lm_update(a_mat, b_vec, lam, scaling, p)
        saved = p.copy()
        use_saved = True

        for iteration in range(1, max_iters + 2):
            if iteration > max_iters or lam >= 1e9:
                error = "max_iters"
                break
            reached = iteration

            if use_saved:
                tentative = saved.copy()
            else:
                p = last_good.copy()
                a_mat, b_vec, chi, err = assemble(
                    model, interp, und_img, def_img, pts, cx, cy, p,
                    positions,
                )
                if err:
                    error = "interp_out_of_image"
                    break
                chi *= scaling
                p = lm_update(a_mat, b_vec, lam, scaling, p)
                tentative = p.copy()

            p = tentative.copy()
            a_mat, b_vec, chi, err = assemble(
                model, interp, und_img, def_img, pts, cx, cy, p, positions
            )
            if err:
                error = "interp_out_of_image"
                break
            chi *= scaling
            p = lm_update(
                a_mat, b_vec, max(lam * 0.4, 1e-9), scaling, p
            )
            saved = p.copy()

            delta_chi = abs(
                (last_good_chi - chi) / (max(last_good_chi, chi) + precision)
            )
            if chi <= last_good_chi:
                last_good_chi = chi
                lam = max(lam * 0.4, 1e-9)
                last_good = tentative.copy()
                use_saved = True
            else:
                lam = min(lam * 10.0, 1e9)
                use_saved = False
            if delta_chi < precision:
                break

    p[: min(2, len(p))] *= 2.0 ** (prev_level - 0)
    return dict(
        params=p, chi=last_good_chi, iterations=reached, error=error
    )
