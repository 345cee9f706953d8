"""Batched Levenberg-Marquardt parameter updates for tiny (NP <= 6) systems.

Replaces CorrelationClass::compute_model_parameters + solve()
(correlation_class.cpp:642-704, 719-768 — Eigen QR) and the cuSolver Cholesky
path (cuda_solver.cu:119-149) with one batched dense solve over all subsets.

The reference's scaling-for-precision (A, b scaled by 1/N) and LM diagonal
damping diag *= (1 + lambda) are applied identically
(correlation_class.cpp:647-665, kernels.cu:12-37).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _chol_solve_rows(a, b, n):
    """Unrolled Cholesky solve on ELEMENT ROWS.

    a: n x n nested list of [1, S] rows (A[i][j] per subset, subsets on
    the minor axis); b: list of n [1, S] rows.  Returns n [1, S]
    solution rows.

    The factorization unrolls into ~n^3/3 elementwise [1, S]-vector ops
    that XLA fuses, instead of jnp.linalg.cholesky's generic batched
    loops over [S, n, n].  Elements stay [1, S]-shaped rows of the
    element-major LM state (engine._PackedState).  Non-PD inputs produce
    NaN/Inf exactly like the library path (rsqrt of a non-positive
    pivot), which the LM driver treats as a diverging step.
    """
    l = [[None] * n for _ in range(n)]
    inv_d = [None] * n
    for j in range(n):
        d = a[j][j]
        for k in range(j):
            d = d - l[j][k] * l[j][k]
        inv = jax.lax.rsqrt(d)
        inv_d[j] = inv
        l[j][j] = d * inv  # sqrt(d); NaN when d <= 0 (singular)
        for i in range(j + 1, n):
            s = a[i][j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s * inv
    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s * inv_d[i]
    # back substitution L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s * inv_d[i]
    return x


def _solve_spd_unrolled(a_mat: jax.Array, b_vec: jax.Array) -> jax.Array:
    """Fully unrolled batched Cholesky solve for NP <= 6 [S, n, n] systems
    (see _chol_solve_rows for the layout rationale)."""
    n = a_mat.shape[-1]
    a_t = jnp.transpose(a_mat, (1, 2, 0)).reshape(n * n, -1)  # [n*n, S]
    b_t = jnp.transpose(b_vec, (1, 0))  # [n, S]
    a = [
        [a_t[i * n + j : i * n + j + 1] for j in range(n)]
        for i in range(n)
    ]
    b = [b_t[i : i + 1] for i in range(n)]
    x = _chol_solve_rows(a, b, n)
    return jnp.concatenate(x, axis=0).T  # [n, S] rows -> [S, n]


def lm_delta_rows(
    a_rows: list,
    b_rows: list,
    lam: jax.Array,
    scaling: jax.Array,
) -> jax.Array:
    """Element-major lm_delta: the LM engine's hot path.

    a_rows: n x n nested list of [1, S] A-element rows (subsets on the
    minor axis); b_rows: list of n [1, S] rows; lam, scaling: [S].
    Returns dp [n, S].  Identical arithmetic to lm_delta — scaling by
    1/N, diagonal damped by (1 + lambda) — on element-major rows.
    """
    n = len(b_rows)
    sc = scaling[None, :]
    damp = (1.0 + lam)[None, :]
    a = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(n):
            e = a_rows[i][j] * sc
            if i == j:
                e = e * damp
            a[i][j] = e
    b = [b_rows[i] * sc for i in range(n)]
    x = _chol_solve_rows(a, b, n)
    return jnp.concatenate(x, axis=0)  # [n, S]


def lm_delta(
    a_mat: jax.Array,
    b_vec: jax.Array,
    lam: jax.Array,
    scaling: jax.Array,
) -> jax.Array:
    """Solve (scaling*A + lambda-damped diagonal) dp = scaling*b per subset.

    Args:
      a_mat: [S, NP, NP] unscaled Gauss-Newton matrix sums.
      b_vec: [S, NP] unscaled right-hand sides.
      lam: [S] per-subset LM damping.
      scaling: [S] per-subset 1/N precision scaling
        (correlation_class.cpp:402).

    Returns:
      dp: [S, NP] parameter updates.  Singular systems yield non-finite
      values; the LM driver treats those as diverging steps.
    """
    a_scaled = a_mat * scaling[:, None, None]
    b_scaled = b_vec * scaling[:, None]
    np_ = a_mat.shape[-1]
    eye = jnp.eye(np_, dtype=a_mat.dtype)
    a_damped = a_scaled * (1.0 + lam[:, None, None] * eye)
    # Batched small dense solve; A is symmetric positive semi-definite with
    # LM damping, Cholesky is the natural factorization (== cuSolver spotrf/
    # spotrs in the reference GPU engine).  NP is static and tiny, so the
    # factorization is fully unrolled (see _solve_spd_unrolled).
    if np_ <= 8:
        return _solve_spd_unrolled(a_damped, b_scaled)
    chol = jnp.linalg.cholesky(a_damped)
    dp = jax.scipy.linalg.cho_solve((chol, True), b_scaled[..., None])[..., 0]
    return dp
