"""The plain reference: serial AU-NMF (the paper's Algorithm 1) in plain
PyTorch, fp32, with TF32 off.

It imports nothing of the program.  From the inputs the benchmark made (A
dense, or A's COO triplets, and the starting factors) it works out again
everything the program derives from them: ‖A‖², the products A·Hᵀ and
AᵀW (the sparse ones by gather and ``index_add_`` over the triplets as
given, with no sorted layout), the Grams, the update rules and the
relative error.

    MU    X ← X ⊙ R / (X G + ε)                          (paper eq. (3))
    HALS  W: w_i ← [w_i G_ii + R_i − X G_i]_+, then w_i / ‖w_i‖
          H: h_i ← [h_i + (R_i − X G_i) / max(G_ii, ε)]_+  (eq. (5))
    BPP   each row of X solves min_{x ≥ 0} ½ xᵀG x − xᵀr exactly, by
          block principal pivoting (Kim & Park 2011), the passive systems
          by Cholesky factorisation

ε = sqrt(the smallest normal fp32), as the program takes it.  The
relative error is ‖A − WH‖/‖A‖ by the trace identity, summed in float64.

``tf32=True`` is the control: the same computation with every product's
operands rounded to TF32 (10 mantissa bits, to nearest even) and summed
in fp32, which is what a TF32 matrix unit does, on any device.
"""

from __future__ import annotations

import contextlib
import math

import torch

EPS = math.sqrt(float(torch.finfo(torch.float32).tiny))

#: elements of one chunk-sized temporary (256 MiB in fp32)
CHUNK_ELEMS = 1 << 26

#: (rows, k, k) elements of one BPP chunk's systems (512 MiB in fp32)
BPP_CHUNK_ELEMS = 1 << 27


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for matrix products while the reference runs."""
    mm = torch.backends.cuda.matmul.allow_tf32
    dnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = dnn


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10 mantissa bits (round to nearest, ties to
    even), kept in fp32 storage."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + (0x0FFF + ((b >> 13) & 1))) & -0x2000
    return b.view(torch.float32)


class Products:
    """The products of A with a factor, A dense (``A``) or as COO triplets
    (``indices`` (2, nnz), ``values``), in ``dtype`` (fp32, or float64 to
    judge the program's error), or in TF32 (``tf32``, the control)."""

    def __init__(self, *, A=None, indices=None, values=None, shape=None,
                 tf32: bool = False, dtype=torch.float32):
        self.A, self.tf32, self.dtype = A, tf32, dtype
        if A is not None:
            self.shape = tuple(A.shape)
        else:
            self.rows, self.cols = indices[0], indices[1]
            self.values, self.shape = values, tuple(shape)

    def _cast(self, x):
        return to_tf32(x) if self.tf32 else x.to(self.dtype)

    def matmul(self, X, Y):
        """X @ Y of two small or factor-sized operands."""
        return self._cast(X) @ self._cast(Y)

    def _exact(self, X) -> bool:
        return not self.tf32 and X.dtype == self.dtype

    def gram(self, X):
        """XᵀX, summed over chunks of rows where X is cast."""
        if self._exact(X):
            return X.T @ X
        k = X.shape[1]
        G = torch.zeros((k, k), dtype=self.dtype, device=X.device)
        rows = max(1, CHUNK_ELEMS // k)
        for r0 in range(0, X.shape[0], rows):
            x = self._cast(X[r0:r0 + rows])
            G += x.T @ x
        return G

    def mm(self, B):
        """A @ B, (m, k)."""
        return self._product(B, transpose=False)

    def mm_t(self, B):
        """Aᵀ @ B, (n, k)."""
        return self._product(B, transpose=True)

    def _product(self, B, *, transpose: bool):
        m, n = self.shape
        k = B.shape[1]
        if self.A is not None and self._exact(self.A):
            return self.A.T @ B if transpose else self.A @ B
        out = torch.zeros((n if transpose else m, k), dtype=self.dtype,
                          device=B.device)
        if self.A is not None:
            rows = max(1, CHUNK_ELEMS // n)
            Bc = self._cast(B) if not transpose else None
            for r0 in range(0, m, rows):
                blk = self._cast(self.A[r0:r0 + rows])
                if transpose:
                    out += blk.T @ self._cast(B[r0:r0 + rows])
                else:
                    out[r0:r0 + rows] = blk @ Bc
            return out
        dst, src = (self.cols, self.rows) if transpose else (self.rows,
                                                              self.cols)
        step = max(1, CHUNK_ELEMS // k)
        for s in range(0, self.values.numel(), step):
            v = self._cast(self.values[s:s + step])
            out.index_add_(0, dst[s:s + step],
                           v[:, None] * self._cast(B[src[s:s + step]]))
        return out

    def norm_sq(self) -> float:
        """‖A‖² in float64."""
        if self.A is None:
            return float((self.values.double() ** 2).sum())
        m, n = self.shape
        rows = max(1, CHUNK_ELEMS // n)
        total = torch.zeros((), dtype=torch.float64, device=self.A.device)
        for r0 in range(0, m, rows):
            blk = self.A[r0:r0 + rows].double()
            total += (blk * blk).sum()
        return float(total)


# ---------------------------------------------------------------------------
# Update rules, in the row-factor form: X (r, k) ≥ 0, G (k, k), R (r, k)
# ---------------------------------------------------------------------------

def mu(P: Products, G, R, X):
    return X * (R / (P.matmul(X, G) + EPS))


def hals_w(P: Products, G, R, X, psum=None):
    """``psum`` sums a column's squares over the ranks that hold the
    column's other rows (None: X holds every row)."""
    X = X.clone()
    for i in range(G.shape[0]):
        xi = X[:, i] * G[i, i] + R[:, i] - P.matmul(X, G[:, i:i + 1])[:, 0]
        xi = torch.clamp_min(xi, 0.0)
        sq = torch.sum(xi * xi)
        nrm = torch.sqrt(sq if psum is None else psum(sq))
        X[:, i] = torch.where(nrm > 0, xi / torch.clamp_min(nrm, EPS), xi)
    return X


def hals_h(P: Products, G, R, X):
    X = X.clone()
    for i in range(G.shape[0]):
        gii = torch.clamp_min(G[i, i], EPS)
        xi = X[:, i] + (R[:, i] - P.matmul(X, G[:, i:i + 1])[:, 0]) / gii
        X[:, i] = torch.clamp_min(xi, 0.0)
    return X


def _passive_solve(G, passive, rhs):
    """x with x_P = G[P,P]⁻¹ rhs_P and x_¬P = 0, row by row (P a row of
    ``passive``), through a Cholesky factor of the masked system (the
    rows and columns outside P replaced by the identity)."""
    p = passive.to(G.dtype)
    k = G.shape[0]
    eye = torch.eye(k, dtype=G.dtype, device=G.device)
    M = G[None] * (p[:, :, None] * p[:, None, :]) + eye * (1.0 - p)[:, :, None]
    L, info = torch.linalg.cholesky_ex(M)
    x = torch.cholesky_solve((rhs * p)[..., None], L)[..., 0]
    bad = info != 0
    if bool(bad.any()):        # not positive definite: an LU solve there
        x[bad] = torch.linalg.solve_ex(M[bad], (rhs * p)[bad])[0]
    return x * p


def _bpp_rows(P: Products, G, R, max_iter: int):
    r, k = R.shape
    dev = R.device
    x = torch.zeros_like(R)
    y = -R
    passive = torch.zeros((r, k), dtype=torch.bool, device=dev)
    ninf_best = torch.full((r,), k + 1, dtype=torch.int64, device=dev)
    chances = torch.full((r,), 3, dtype=torch.int64, device=dev)
    cols = torch.arange(k, device=dev)
    todo = torch.arange(r, device=dev)
    for _ in range(max_iter):
        bad = (passive[todo] & (x[todo] < 0)) | (~passive[todo] & (y[todo] < 0))
        nbad = bad.sum(1)
        left = nbad > 0
        todo, bad, nbad = todo[left], bad[left], nbad[left]
        if todo.numel() == 0:
            break
        better = nbad < ninf_best[todo]
        full = better | (chances[todo] > 0)
        ninf_best[todo] = torch.where(better, nbad, ninf_best[todo])
        chances[todo] = torch.where(better, 3,
                                    torch.where(full, chances[todo] - 1,
                                                chances[todo]))
        top = torch.where(bad, cols, -1).amax(1)
        flip = torch.where(full[:, None], bad, cols[None, :] == top[:, None])
        pas = passive[todo] ^ flip
        xs = _passive_solve(G, pas, R[todo])
        ys = P.matmul(xs, G) - R[todo]
        passive[todo] = pas
        x[todo] = xs
        y[todo] = torch.where(pas, 0.0, ys)
    return torch.clamp_min(x, 0.0)


def bpp(P: Products, G, R, X=None, *, max_iter: int | None = None):
    del X                       # an exact solve: no warm start
    r, k = R.shape
    max_iter = 5 * k + 10 if max_iter is None else max_iter
    rows = max(1, BPP_CHUNK_ELEMS // (k * k))
    return torch.cat([_bpp_rows(P, G, R[r0:r0 + rows], max_iter)
                      for r0 in range(0, r, rows)])


RULES = {"mu": (mu, mu), "hals": (hals_w, hals_h), "bpp": (bpp, bpp)}


def sq_error(normA_sq: float, AtW, Ht, WtW, HHt) -> float:
    """‖A − WH‖² = ‖A‖² − 2 tr(WᵀA Hᵀ) + tr(WᵀW HHᵀ), summed in float64
    (the cross term over chunks of rows)."""
    quad = float((WtW.double() * HHt.double()).sum())
    return normA_sq - 2.0 * dot64(AtW, Ht) + quad


def dot64(X, Y) -> float:
    """⟨X, Y⟩ of two (r, k) panels, summed in float64 over chunks of
    rows."""
    rows = max(1, CHUNK_ELEMS // Y.shape[1])
    return sum(float((X[r0:r0 + rows].double()
                      * Y[r0:r0 + rows].double()).sum())
               for r0 in range(0, Y.shape[0], rows))


def rel_error(P: Products, W, Ht) -> float:
    """The relative error of given factors (the program's, to judge its
    own), from products in ``P``'s dtype (float64 for that)."""
    normA_sq = P.norm_sq()
    sq = sq_error(normA_sq, P.mm_t(W), Ht, P.gram(W), P.gram(Ht))
    return math.sqrt(max(sq, 0.0) / normA_sq)


def segment(P: Products, rule: str, W0, H0, iters: int):
    """``iters`` iterations of Algorithm 1 from (W0, H0), in ``P``'s dtype
    (float64 only as a witness of what fp32 rounding does to a fit): the
    factors W (m, k), Hᵀ (n, k) after them and the relative error after
    each."""
    upd_w, upd_h = RULES[rule]
    normA_sq = P.norm_sq()
    W, Ht = W0.to(P.dtype).clone(), H0.to(P.dtype).T.contiguous()
    rels = []
    with exact_fp32():
        for _ in range(iters):
            W = upd_w(P, P.gram(Ht), P.mm(Ht), W)
            WtW = P.gram(W)
            AtW = P.mm_t(W)
            Ht = upd_h(P, WtW, AtW, Ht)
            sq = sq_error(normA_sq, AtW, Ht, WtW, P.gram(Ht))
            rels.append(math.sqrt(max(sq, 0.0) / normA_sq))
    return W, Ht, rels
