"""A cell's ranks: the grid's geometry, the benchmark's own collectives, and
the plain reference and the judge split across the ranks.

A ranked cell runs one process per card, rank r at cell (i, j) =
divmod(r, pc) of its configuration's pr × pc ``"grid"`` (the order of
``make_faun_grid``).  Rank (i, j) holds

    A     block (i, j): rows i·m/pr …, columns j·n/pc … (its own triplets)
    W     the program's rows (i·pc + j)·m/p …, m/p of them
    Hᵀ    the program's rows (j·pr + i)·n/p …, n/p of them

and the split reference (``Ranks.segment``) holds the factor rows its block
touches: W's block row i (m/pr rows) and Hᵀ's block column j (n/pc rows).
Its products and Grams are partial sums over the rank's triplets, summed by
plain ``torch.distributed`` calls over the grid row (ranks {i·pc + j'}: one
block of each column) or the grid column ({i'·pc + j}).  Nothing of the
program is imported: the groups are the benchmark's own.

Each rank judges its own m/p rows of W and n/p rows of Hᵀ; the worst row is
the largest over the ranks, against the median row norm of all of them,
and the program's relative error is worked out again in float64 from the
same split (``rel_error``).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

import gen
import judge
import reference


class Ranks:
    """This rank's place on the cell's grid, and the collectives over it.
    Every rank makes one, in the same order: it makes process groups."""

    def __init__(self, cfg: dict, device: torch.device):
        self.pr, self.pc = cfg["grid"]
        self.p = self.pr * self.pc
        if dist.get_world_size() != self.p:
            raise ValueError(f"a {self.pr} × {self.pc} grid needs {self.p} "
                             f"ranks, the process group has "
                             f"{dist.get_world_size()}")
        self.rank = dist.get_rank()
        self.i, self.j = divmod(self.rank, self.pc)
        self.m, self.n, self.device = cfg["m"], cfg["n"], device
        if self.m % self.p or self.n % self.p:
            raise ValueError(f"A of {self.m} × {self.n} does not split into "
                             f"the rows of {self.p} ranks")
        self.mb, self.nb = self.m // self.pr, self.n // self.pc
        self.wr, self.hr = self.m // self.p, self.n // self.p
        rows = [dist.new_group([i * self.pc + j for j in range(self.pc)])
                for i in range(self.pr)]
        cols = [dist.new_group([i * self.pc + j for i in range(self.pr)])
                for j in range(self.pc)]
        self.row, self.col = rows[self.i], cols[self.j]

    @property
    def shape(self) -> tuple[int, int]:
        return self.pr, self.pc

    @property
    def block(self) -> tuple[int, int]:
        return self.i, self.j

    # -- collectives ---------------------------------------------------------

    def _scalar(self, value) -> torch.Tensor:
        return torch.tensor([float(value)], dtype=torch.float64,
                            device=self.device)

    def sum(self, value: float, group=None) -> float:
        t = self._scalar(value)
        dist.all_reduce(t, group=group)
        return float(t)

    def max(self, value: float) -> float:
        t = self._scalar(value)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t)

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank."""
        t = self._scalar(flag)
        dist.broadcast(t, src=0)
        return bool(t)

    def barrier(self) -> None:
        """Every rank has reached this point and its device is idle."""
        self.sum(0.0)

    def gather(self, values: list) -> list:
        """Every rank's list of numbers (the same length), in rank order."""
        t = torch.tensor(values, dtype=torch.float64, device=self.device)
        out = t.new_empty((self.p * t.numel(),))
        dist.all_gather_into_tensor(out, t)
        return out.view(self.p, -1).tolist()

    def reduce(self, x: torch.Tensor, group) -> torch.Tensor:
        """``x`` summed over ``group``, in place."""
        dist.all_reduce(x, group=group)
        return x

    def _psum_col(self, x: torch.Tensor) -> torch.Tensor:
        return self.reduce(x.clone(), self.col)

    def _panel(self, X: torch.Tensor, group) -> torch.Tensor:
        """The rows of ``group``'s ranks stacked in group order."""
        X = X.contiguous()
        out = X.new_empty((dist.get_world_size(group) * X.shape[0],)
                          + tuple(X.shape[1:]))
        dist.all_gather_into_tensor(out, X, group=group)
        return out

    # -- the split reference -------------------------------------------------

    def localize(self, inputs: dict) -> None:
        """The rank's triplets shifted, in place, to its block's origin."""
        inputs["indices"][0] -= self.i * self.mb
        inputs["indices"][1] -= self.j * self.nb

    def products(self, inputs: dict, **kw) -> reference.Products:
        """``reference.Products`` of the rank's block (``localize``d)."""
        return reference.Products(indices=inputs["indices"],
                                  values=inputs["values"],
                                  shape=(self.mb, self.nb), **kw)

    def start(self, cfg: dict, traffic: dict, seed: int):
        """(W0's block row, H0ᵀ's block column) of the seed's starting
        factors (``gen.starting_factors``)."""
        rows = slice(self.i * self.mb, (self.i + 1) * self.mb)
        cols = slice(self.j * self.nb, (self.j + 1) * self.nb)
        f = gen.starting_factors(cfg, traffic, seed, self.device,
                                 (rows, cols))
        return f["W0"], f["Ht0"]

    def own(self, W: torch.Tensor, Ht: torch.Tensor):
        """The program's rows of this rank out of W's block row and Hᵀ's
        block column."""
        return (W[self.j * self.wr:(self.j + 1) * self.wr],
                Ht[self.i * self.hr:(self.i + 1) * self.hr])

    def segment(self, P: reference.Products, cfg: dict, traffic: dict,
                seed: int, iters: int) -> dict:
        """``reference.segment`` over the ranks, from the seed's starting
        factors (``start``, drawn here so that nothing else holds them):
        this rank's own rows of W and Hᵀ after ``iters`` iterations, and
        the relative error after each (the same on every rank)."""
        upd_w, upd_h = reference.RULES[traffic["rule"]]
        if upd_w is reference.hals_w:
            def upd_w(P, G, R, X):
                return reference.hals_w(P, G, R, X, psum=self._psum_col)
        else:
            upd_w = _by_rows(upd_w)
        upd_h = _by_rows(upd_h)
        normA_sq = self.sum(P.norm_sq())
        W, Ht = (X.to(P.dtype) for X in self.start(cfg, traffic, seed))
        rels = []
        with reference.exact_fp32():
            for _ in range(iters):
                G = self.reduce(P.gram(Ht), self.row)
                W = upd_w(P, G, self.reduce(P.mm(Ht), self.row), W)
                WtW = self.reduce(P.gram(W), self.col)
                AtW = self.reduce(P.mm_t(W), self.col)
                Ht = upd_h(P, WtW, AtW, Ht)
                HHt = self.reduce(P.gram(Ht), self.row)
                cross = self.sum(reference.dot64(AtW, Ht), self.row)
                quad = float((WtW.double() * HHt.double()).sum())
                sq = normA_sq - 2.0 * cross + quad
                rels.append(math.sqrt(max(sq, 0.0) / normA_sq))
        W_own, Ht_own = self.own(W, Ht)
        return {"W": W_own.clone(), "Ht": Ht_own.clone(), "rels": rels}

    # -- the judge -----------------------------------------------------------

    def gaps(self, X: torch.Tensor, Xr: torch.Tensor) -> tuple[float, float]:
        """``judge``'s (worst row gap, Frobenius gap) over every rank's own
        rows: the worst row against the median row norm of all ranks."""
        diff, norm = judge.row_gaps(X, Xr)
        tiny = torch.finfo(torch.float64).tiny
        floor = self._panel(norm, None).median().clamp_min(tiny)
        row = self.max(float((diff / torch.maximum(norm, floor)).max()))
        d2 = self.sum(float((diff * diff).sum()))
        n2 = self.sum(float((norm * norm).sum()))
        return row, math.sqrt(d2) / max(math.sqrt(n2), tiny)

    def rel_error(self, inputs: dict, W: torch.Tensor,
                  Ht: torch.Tensor) -> float:
        """The relative error of the program's factors, this rank holding
        its own rows of each, in float64: ‖A‖² − 2⟨AᵀW, Hᵀ⟩ + ⟨WᵀW, HHᵀ⟩,
        the cross term as Σ a_rc ⟨W_r, Hᵀ_c⟩ over the rank's triplets."""
        rows, cols = inputs["indices"]
        values = inputs["values"]
        normA_sq = self.sum(float((values.double() ** 2).sum()))
        Wi, Htj = self._panel(W, self.row), self._panel(Ht, self.col)
        step = max(1, reference.CHUNK_ELEMS // W.shape[1])
        cross = 0.0
        for s in range(0, values.numel(), step):
            w = Wi[rows[s:s + step]].double()
            h = Htj[cols[s:s + step]].double()
            cross += float((values[s:s + step].double()
                            * (w * h).sum(1)).sum())
        del Wi, Htj
        cross = self.sum(cross)
        P64 = self.products(inputs, dtype=torch.float64)
        WtW = self.reduce(P64.gram(W), None)
        HHt = self.reduce(P64.gram(Ht), None)
        sq = normA_sq - 2.0 * cross + float((WtW * HHt).sum())
        return math.sqrt(max(sq, 0.0) / normA_sq)

    def judge_outputs(self, inputs: dict, out: dict, ref: dict) -> dict:
        """Every number of ``judge`` for the program's own rows ``out``
        against the split reference's ``ref`` (``segment``); ``inputs``
        ``localize``d."""
        exact = self.rel_error(inputs, out["W"], out["Ht"])
        return judge.numbers(out, ref, exact, gaps=self.gaps)


def _by_rows(update):
    """A row-local rule (MU, HALS's H sweep, BPP) applied a chunk of rows
    at a time, in place: no factor-sized temporary beside the factor."""
    def apply(P, G, R, X):
        rows = max(1, reference.CHUNK_ELEMS // X.shape[1])
        for r0 in range(0, X.shape[0], rows):
            X[r0:r0 + rows] = update(P, G, R[r0:r0 + rows], X[r0:r0 + rows])
        return X
    return apply
