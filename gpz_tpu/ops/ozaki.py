"""Ozaki-scheme matmuls: float64-accurate contractions from bf16 products.

For a machine whose float64 dot is not float64-accurate (or not fast), this
module computes f64 contractions exact to ~1e-14 from bf16 matrix products
with float32 accumulation, using the error-free splitting of Ozaki et al.
(accurate matmul by slicing into low-mantissa pieces; the same scheme the
ozIMMU/ozaki-scheme GEMM libraries use on f16/int8 tensor cores):

  1. Each factor column is written as a sum of Q slices of S=7 significant
     bits, aligned to one power-of-two grid per (row-block, column):
     t_i = round(r / g_i) * g_i, r <- r - t_i, g_{i+1} = g_i * 2^-S.
     Every slice is exactly representable in bfloat16 (8-bit significand).
  2. A slice-pair product has <= 2S+2 significant bits, so a matmul of a
     row block of B <= 2^(24-2S-2) rows accumulates it EXACTLY in a float32
     accumulator — provided the hardware accumulates bf16 products in (at
     least) float32 without intermediate rounding. That is a property of
     the matrix unit, not of this code; `chip_smoke.py` checks it on the
     card it runs on.
  3. The exact per-block, per-slice-pair partials are summed in f64.
     Slice pairs with i + j >= Q contribute below 2^(-S*Q) relative and
     are dropped.

Cost: ~Q(Q+1)/2 bf16 matmuls (f64 inputs: Q=8 -> 20 matmuls exploiting Gram
symmetry; f32 inputs: Q=5 -> 9). CPU and GPU contract natively in float64, so
the objective uses this path only when asked (objective._ozaki_active).
Reference anchor: the Gram accumulation PHI' * diag(beta) * PHI of ref
GPz/GPz.m:63-65, which MATLAB computes in native f64.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

#: significant bits per slice; products have 2S+2 bits (slice integers reach
#: +-2^S at the top slice after a conservative sigma), so block rows must
#: satisfy 2S + 2 + log2(B) <= 24 for exact f32 accumulation
_S = 7
#: rows per f32 accumulation block: with S=7 the slice integers are <= 65
#: (<2^7), products <= 65^2 < 2^13, so exactness needs 13 + log2(B) <= 24
#: -> B <= 2048.
_BLOCK = 2048


def _nslices(dtype) -> int:
    # enough slices that the dropped i+j >= Q tail (~2^-7Q of the column
    # scale) is negligible: f64 -> 8 (2^-56), f32 -> 5 (2^-35; with 4 the
    # tail measures ~1e-6 on wide-dynamic-range columns, since entries far
    # below the column max are only captured to the shared absolute grid)
    return 8 if jnp.dtype(dtype) == jnp.float64 else 5


def _slice_blocks(X, q):
    """Split X (nb, B, a) into q bf16 slices on per-(block, column) grids.

    Exact: sum(slices) + residual == X in exact arithmetic, each slice is a
    multiple of its power-of-two grid with integer part < 2^S (bf16-exact).
    """
    amax = jnp.max(jnp.abs(X), axis=1, keepdims=True)           # (nb, 1, a)
    sigma = jnp.exp2(jnp.ceil(jnp.log2(jnp.where(amax > 0, amax, 1.0))))
    # log2 is not correctly rounded on every backend: if it under-reads an
    # exact power of two, sigma < amax breaks the <2^S integer bound — guard
    sigma = jnp.where(sigma < amax, 2.0 * sigma, sigma)
    out = []
    r = X
    for _ in range(q):
        grid = sigma * jnp.exp2(jnp.asarray(1 - _S, X.dtype))
        t = jnp.round(r / grid) * grid
        out.append(t.astype(jnp.bfloat16))
        r = r - t
        sigma = sigma * jnp.exp2(jnp.asarray(-_S, X.dtype))
    return out


def _block(X, block):
    """(c, a) -> (nb, B, a) zero-padded row blocks (B <= block: a shorter
    contraction never hurts exactness, and avoids padding a 100-row factor
    out to 2048)."""
    c, a = X.shape
    b = min(block, c)
    nb = -(-c // b)
    if nb * b != c:
        X = jnp.pad(X, ((0, nb * b - c), (0, 0)))
    return X.reshape(nb, b, a)


def _pair(si, sj):
    """Exact f32-accumulated block matmul of two bf16 slices -> f64 (a, b)."""
    p = jnp.einsum("cna,cnb->cab", si, sj,
                   preferred_element_type=jnp.float32)
    return jnp.sum(p.astype(jnp.float64), axis=0)


def _gram_impl(W, block):
    q = _nslices(W.dtype)
    s = _slice_blocks(_block(W, block), q)
    m = W.shape[1]
    A = jnp.zeros((m, m), jnp.float64)
    for i in range(q):
        for j in range(i, q - i):
            P = _pair(s[i], s[j])
            A = A + (P if i == j else P + P.T)
    return A


def _tn_impl(X, Y, block):
    q = max(_nslices(X.dtype), _nslices(Y.dtype))
    sx = _slice_blocks(_block(X, block), q)
    sy = _slice_blocks(_block(Y, block), q)
    out = jnp.zeros((X.shape[1], Y.shape[1]), jnp.float64)
    for i in range(q):
        for j in range(q - i):
            out = out + _pair(sx[i], sy[j])
    return out


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def ozaki_gram(W, block=_BLOCK):
    """W^T W in float64 to ~1e-14, via exact bf16 slice products.

    W: (n, m) float64 or float32. The result is the *exact* Gram of the
    stored W (to the dropped-tail ~2^-56 / ~2^-28), not of some rounded
    copy — so the objective built on it is smooth in the parameters.
    """
    return _gram_impl(W, block)


def _gram_fwd(W, block):
    return _gram_impl(W, block), W


def _mm(X, M, block):
    """X (n, a) @ M (a, b) at the accuracy of X's dtype: exact slice
    products for f64 (a plain f64 dot would reintroduce the f32-grade jag);
    one HIGHEST-precision matmul for f32 (the f32 path's error floor is
    the f32 inputs themselves — slice products would cost 9 matmuls + an
    extraction sweep for accuracy the cotangent can't use)."""
    if jnp.dtype(X.dtype) == jnp.float64:
        return _tn_impl(X.T, M.astype(jnp.float64), block)
    return jnp.matmul(X, M.astype(X.dtype),
                      precision=jax.lax.Precision.HIGHEST)


def _gram_bwd(block, W, Abar):
    # A = W^T W  =>  Wbar = W (Abar + Abar^T)
    M = Abar + Abar.T
    Wbar = _mm(W, M, block)
    return (Wbar.astype(W.dtype),)


ozaki_gram.defvjp(_gram_fwd, _gram_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def ozaki_tn(X, Y, block=_BLOCK):
    """X^T Y in float64 to ~1e-14 (X: (c, a), Y: (c, b), contract over c)."""
    return _tn_impl(X, Y, block)


def _tn_fwd(X, Y, block):
    return _tn_impl(X, Y, block), (X, Y)


def _tn_bwd(block, res, Obar):
    X, Y = res
    Xbar = _mm(Y, Obar.T, block)                              # (c,a) = Y Obar^T
    Ybar = _mm(X, Obar, block)                                # (c,b) = X Obar
    return Xbar.astype(X.dtype), Ybar.astype(Y.dtype)


ozaki_tn.defvjp(_tn_fwd, _tn_bwd)
