"""The references' sparse products X w and X^T r over fixed-width rows
(``idx`` / ``val`` [n, k]; a padding slot holds the value 0).

In float64 both products are CSR matrix-vector products (the matrix and
its transpose built once, by a sort of the entries by column), so the
many rows that share a column (the intercept, the integer columns, a
frequent category) add without contention. In a lower precision, where
PyTorch's sparse products do not run, the values are kept in that
precision and the products summed in ``acc``: a gather for X w and
``index_add_`` for X^T r, in row blocks.
"""

from __future__ import annotations

import warnings

import torch

BLOCK_ROWS = 1 << 20


def _csr(crow, col, val, size):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "sparse CSR support is in beta"
        return torch.sparse_csr_tensor(crow, col, val, size, check_invariants=False)


class SparseRows:
    def __init__(self, idx: torch.Tensor, val: torch.Tensor, cols: int, dtype):
        self.n, self.k = idx.shape
        self.cols, self.dtype = int(cols), dtype
        dev = idx.device
        if dtype == torch.float64:
            flat_i = idx.reshape(-1)
            flat_v = val.reshape(-1).to(dtype)
            crow = torch.arange(self.n + 1, device=dev, dtype=torch.int64) * self.k
            self.X = _csr(crow, flat_i, flat_v, (self.n, self.cols))
            order = torch.argsort(flat_i)
            rows = (torch.arange(self.n * self.k, device=dev) // self.k)[order]
            counts = torch.bincount(flat_i, minlength=self.cols)
            crow_t = torch.zeros(self.cols + 1, dtype=torch.int64, device=dev)
            crow_t[1:] = torch.cumsum(counts, 0)
            self.XT = _csr(crow_t, rows, flat_v[order], (self.cols, self.n))
            del order, rows
        else:
            self.idx, self.val = idx, val.to(dtype)

    def matvec(self, w: torch.Tensor, acc) -> torch.Tensor:
        """X w, summed in ``acc``."""
        if self.dtype == torch.float64:
            return (self.X @ w.to(torch.float64).unsqueeze(1)).squeeze(1).to(acc)
        out = torch.empty(self.n, dtype=acc, device=w.device)
        for a in range(0, self.n, BLOCK_ROWS):
            out[a:a + BLOCK_ROWS] = (self.val[a:a + BLOCK_ROWS] * w[self.idx[a:a + BLOCK_ROWS]]).sum(
                1, dtype=acc)
        return out

    def rmatvec(self, r: torch.Tensor, acc) -> torch.Tensor:
        """X^T r, summed in ``acc`` (``r`` in the values' precision)."""
        if self.dtype == torch.float64:
            return (self.XT @ r.to(torch.float64).unsqueeze(1)).squeeze(1).to(acc)
        g = torch.zeros(self.cols, dtype=acc, device=r.device)
        for a in range(0, self.n, BLOCK_ROWS):
            prod = self.val[a:a + BLOCK_ROWS] * r[a:a + BLOCK_ROWS, None].to(self.dtype)
            g.index_add_(0, self.idx[a:a + BLOCK_ROWS].reshape(-1), prod.reshape(-1).to(acc))
        return g
