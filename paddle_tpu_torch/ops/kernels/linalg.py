"""Linear-algebra kernels: port of `paddle_tpu/ops/kernels/linalg.py`
(torch.matmul and torch.linalg; cuBLAS and cuSOLVER on the card)."""
from __future__ import annotations

import numpy as np
import torch

from ..dispatch import register_op


@register_op
def matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


@register_op
def dot(x, y):
    return torch.sum(x * y, -1)


@register_op
def mm(x, y):
    return torch.matmul(x, y)


@register_op
def bmm(x, y):
    return torch.matmul(x, y)


@register_op
def inner(x, y):
    return torch.inner(x, y)


@register_op
def outer(x, y):
    return torch.outer(x.reshape(-1), y.reshape(-1))


@register_op
def mv(x, vec):
    return torch.matmul(x, vec)


@register_op
def kron(x, y):
    return torch.kron(x, y)


@register_op
def cross(x, y, axis=None):
    if axis is None:
        axis = next(i for i, s in enumerate(x.shape) if s == 3)
    return torch.linalg.cross(x, y, dim=axis)


@register_op
def addmm(input, x, y, beta=1.0, alpha=1.0):
    return beta * input + alpha * torch.matmul(x, y)


@register_op
def norm(x, p="fro", axis=None, keepdim=False):
    if p == "fro" and axis is None:
        return torch.sqrt(torch.sum(torch.square(x)))
    if axis is None:
        x, axis = x.reshape(-1), 0
    if isinstance(axis, list):
        axis = tuple(axis)
    if p == "fro":
        return torch.sqrt(torch.sum(torch.square(x), axis, keepdim=keepdim))
    if p == float("inf"):
        return torch.amax(torch.abs(x), axis, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(x), axis, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), axis, keepdim=keepdim)
    return torch.pow(torch.sum(torch.pow(torch.abs(x), p), axis,
                               keepdim=keepdim), 1.0 / p)


@register_op
def p_norm(x, porder=2.0, axis=-1, keepdim=False, epsilon=1e-12):
    return torch.pow(torch.sum(torch.pow(torch.abs(x), porder), axis,
                               keepdim=keepdim) + epsilon, 1.0 / porder)


@register_op
def cholesky(x, upper=False):
    return torch.linalg.cholesky(x, upper=upper)


@register_op
def qr(x, mode="reduced"):
    q, r = torch.linalg.qr(x, mode=mode)
    return q, r


@register_op
def svd(x, full_matrices=False):
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices)
    return u, s, vh


@register_op
def eigh(x, UPLO="L"):
    w, v = torch.linalg.eigh(x, UPLO=UPLO)
    return w, v


@register_op(nondiff=True)
def eig(x):
    """numpy's rule, as the reference (which calls numpy): real outputs
    when every eigenvalue is real."""
    w, v = torch.linalg.eig(x)
    if not bool(torch.any(w.imag != 0)):
        return w.real.contiguous(), v.real.contiguous()
    return w, v


@register_op
def eigvalsh(x, UPLO="L"):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


@register_op
def inverse(x):
    return torch.linalg.inv(x)


@register_op
def pinv(x, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


@register_op
def solve(x, y):
    return torch.linalg.solve(x, y)


@register_op
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    a = x.transpose(-1, -2) if transpose else x
    return torch.linalg.solve_triangular(
        a, y, upper=upper != transpose, unitriangular=unitriangular)


@register_op
def cholesky_solve(x, y, upper=False):
    return torch.cholesky_solve(x, y, upper=upper)


@register_op
def lstsq(x, y, rcond=None, driver=None):
    # the SVD driver, as numpy's and jax's lstsq: residuals, rank and
    # singular values come back with the solution
    sol, res, rank, sv = torch.linalg.lstsq(
        x.cpu(), y.cpu(), rcond=rcond, driver="gelsd")
    return tuple(t.to(x.device) for t in (sol, res, rank, sv))


@register_op
def matrix_power(x, n):
    return torch.linalg.matrix_power(x, n)


@register_op(nondiff=True)
def matrix_rank(x, tol=None, hermitian=False):
    return torch.linalg.matrix_rank(x, atol=tol, hermitian=hermitian) \
        if tol is not None else torch.linalg.matrix_rank(x,
                                                         hermitian=hermitian)


@register_op
def det(x):
    return torch.linalg.det(x)


@register_op
def slogdet(x):
    sign, logabs = torch.linalg.slogdet(x)
    return torch.stack([sign, logabs])


@register_op
def trace(x, offset=0, axis1=0, axis2=1):
    return torch.sum(torch.diagonal(x, offset, axis1, axis2), -1)


@register_op
def lu(x, pivot=True):
    lu_, piv = torch.linalg.lu_factor(x, pivot=pivot)
    return lu_, piv   # 1-based pivots, as paddle's


@register_op
def cond(x, p=None):
    return torch.linalg.cond(x, p=p)


@register_op
def multi_dot(xs):
    return torch.linalg.multi_dot(list(xs))


@register_op
def householder_product(x, tau):
    return torch.linalg.householder_product(x, tau)


@register_op
def corrcoef(x, rowvar=True):
    return torch.corrcoef(x if rowvar else x.T)


@register_op
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    return torch.cov(x if rowvar else x.T, correction=1 if ddof else 0,
                     fweights=fweights, aweights=aweights)


@register_op
def histogram(x, bins=100, min=0, max=0, weight=None, density=False):
    lo, hi = (float(x.min()), float(x.max())) if (min == 0 and max == 0) \
        else (float(min), float(max))
    hist, _ = np.histogram(x.detach().cpu().numpy(), bins=bins,
                           range=(lo, hi),
                           weights=None if weight is None
                           else weight.detach().cpu().numpy(),
                           density=density)
    # float counts, as the reference's (jnp.histogram's) dtype
    return torch.as_tensor(hist, dtype=torch.get_default_dtype(),
                           device=x.device)


@register_op
def einsum(equation, *operands):
    return torch.einsum(equation, *operands)
