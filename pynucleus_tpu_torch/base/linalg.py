"""Spectral estimates by Krylov loops on tensors.

Port of pynucleus_tpu/base/linalg.py: estimateSpectralRadius (power
iteration), lanczos (the three-term recurrence), lanczosSpectralBounds and
arnoldi (modified Gram-Schmidt).  The Chebyshev smoother needs the
spectral radius of D^{-1}A.  As in the JAX package these are host loops
over applies: the start vector is the same
``np.random.RandomState(seed).rand(n) - 0.5``, the scalars that decide
the loops (norms, dot products) are read to the host each step and the
stopping tests are the JAX package's, code for code.  The applies run on
the operator's device (its own kernels); norms and dot products are
torch calls there.
"""
import numpy as np
import torch

__all__ = ['estimateSpectralRadius', 'lanczos', 'lanczosSpectralBounds',
           'arnoldi']


def _start(A, seed):
    """The normalised start vector of the JAX package's loops, on A's
    device."""
    v = torch.as_tensor(np.random.RandomState(seed).rand(A.num_rows),
                        device=A.device) - 0.5
    return v / torch.linalg.norm(v)


def estimateSpectralRadius(A, Dinv=None, maxiter=50, tol=1e-4, seed=0):
    """Spectral radius of (Dinv *) A by power iteration
    (pynucleus_tpu/base/linalg.py:15)."""
    x = _start(A, seed)

    def apply(v):
        w = A.matvec(v)
        if Dinv is not None:
            w = Dinv * w
        return w

    lam = 0.0
    for _ in range(maxiter):
        y = apply(x)
        lamNew = float(torch.linalg.norm(y))
        if lamNew == 0.0:
            return 0.0
        x = y / lamNew
        if abs(lamNew - lam) < tol * abs(lamNew):
            lam = lamNew
            break
        lam = lamNew
    return lam


def lanczos(A, k=20, Dinv=None, seed=0):
    """k-step Lanczos: (alphas, betas) of the tridiagonal matrix whose
    eigenvalues approximate those of (Dinv *) A
    (pynucleus_tpu/base/linalg.py:42)."""
    q = _start(A, seed)
    qm = torch.zeros_like(q)
    alphas, betas = [], []
    beta = 0.0
    for _ in range(k):
        w = A.matvec(q)
        if Dinv is not None:
            w = Dinv * w
        alpha = float(q @ w)
        w = w - alpha * q - beta * qm
        beta = float(torch.linalg.norm(w))
        alphas.append(alpha)
        betas.append(beta)
        if beta < 1e-14:
            break
        qm = q
        q = w / beta
    return np.asarray(alphas), np.asarray(betas)


def lanczosSpectralBounds(A, Dinv=None, k=20, safety=1.05):
    """(lmin, lmax) eigenvalue estimates from the Lanczos tridiagonal,
    inflated by ``safety`` (pynucleus_tpu/base/linalg.py:68)."""
    alphas, betas = lanczos(A, k=k, Dinv=Dinv)
    m = len(alphas)
    T = np.diag(alphas)
    for i in range(m - 1):
        T[i, i + 1] = T[i + 1, i] = betas[i]
    ev = np.linalg.eigvalsh(T)
    return float(ev[0] / safety), float(ev[-1] * safety)


def arnoldi(A, k=20, seed=0):
    """k-step Arnoldi: the upper-Hessenberg H [k+1, k] (host) and the basis
    V [n, k+1] on A's device (pynucleus_tpu/base/linalg.py:80)."""
    V = [_start(A, seed)]
    H = np.zeros((k + 1, k))
    for j in range(k):
        w = A.matvec(V[j])
        for i in range(j + 1):
            H[i, j] = float(V[i] @ w)
            w = w - H[i, j] * V[i]
        H[j + 1, j] = float(torch.linalg.norm(w))
        if H[j + 1, j] < 1e-14:
            H = H[:j + 2, :j + 1]
            break
        V.append(w / H[j + 1, j])
    return H, torch.stack(V, dim=1)
