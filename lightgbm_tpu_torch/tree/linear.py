"""Piecewise-linear leaves — PyTorch counterpart of lightgbm_tpu/tree/linear.py
(the LeafFit strategy plug-in; "Gradient Boosting With Piece-Wise Linear
Regression Trees", 1802.05640).

After a tree's structure is grown with the constant-leaf gain scan, each
leaf gets a ridge least-squares model over the numerical features on its
root path.  Leaf l minimises

    sum_i  h_i/2 (w·x~_i)^2 + g_i (w·x~_i)  + reg(w)

over its selected rows, x~ = (1, x_1..x_k): (A + D) w = -b with
A = sum h_i x~ x~^T, b = sum g_i x~, and D ``linear_lambda`` on the slope
diagonal, ``lambda_l2`` on the intercept and 1 on padded slots.

Fits and binned score updates read a feature at its bin's representative
value (``build_value_lut``); raw prediction reads the raw value.

The JAX package scatters per-row outer products into (L, k+1, k+1)
float32 sums block by block.  Here the rows are sorted by leaf once
(stable), and each leaf's path columns are read from the bins (the mask
grower's packed words) for its rows only, so each leaf's A and b are one
float64 matmul each; they are rounded to float32 once, as the port's
histograms are, so a card and a CPU run give the same values nearly
always.  No (N, k+1, k+1) tensor is ever built (70 GB in float64 at
10.5M rows, k = 28).  The solve is a batched Cholesky in float64;
``cholesky_ex`` flags a matrix that is not positive definite, where the
JAX package's float32 Cholesky returns NaN: either way the leaf keeps its
constant output.
"""

from __future__ import annotations

import numpy as np
import torch

# rows a linear-leaf evaluation takes at once: its (rows, k) tensors stay
# near a few hundred MB
ROW_STEP = 1 << 20


def build_value_lut(dataset, num_bins: int) -> np.ndarray:
    """(F, num_bins) float32 bin-representative values per INNER feature:
    a numerical bin's upper bound (the split threshold Tree records), the
    last bin's +inf bound replaced by the largest finite one; categorical
    columns zero (they never enter a fit)."""
    from ..io.binning import CATEGORICAL

    f = dataset.num_features
    lut = np.zeros((f, num_bins), np.float32)
    for i in range(f):
        m = dataset.bin_mappers[i]
        if m.bin_type == CATEGORICAL:
            continue
        nb = int(m.num_bin)
        vals = np.asarray(m.bin_upper_bound, np.float64)[:nb].copy()
        if nb >= 2 and not np.isfinite(vals[nb - 1]):
            vals[nb - 1] = vals[nb - 2]
        vals = np.where(np.isfinite(vals), vals, 0.0)
        lut[i, :nb] = vals.astype(np.float32)
        if nb < num_bins:
            lut[i, nb:] = lut[i, nb - 1]
    return lut


def leaf_path_features(gr, is_categorical) -> list:
    """Per-leaf tuples of the INNER numerical features on the leaf's root
    path, from the grower's split records (the left child keeps the split
    leaf's index, the right one is s + 1)."""
    rec_leaf = np.asarray(gr.rec_leaf)
    rec_feat = np.asarray(gr.rec_feat)
    is_cat = np.asarray(is_categorical)
    feats = {0: ()}
    for s in range(int(gr.num_splits)):
        bl, f = int(rec_leaf[s]), int(rec_feat[s])
        path = feats[bl]
        if not is_cat[f] and f not in path:
            path = path + (f,)
        feats[bl] = feats[s + 1] = path
    return [feats[i] for i in range(int(gr.num_splits) + 1)]


def pack_path_features(paths, num_leaves: int, k_max: int = 0):
    """(L, k) int32 feature indices (0-padded) and (L, k) float32 validity
    of per-leaf path tuples, k at least ``k_max``."""
    k = max(max((len(p) for p in paths), default=0), k_max, 1)
    idx = np.zeros((num_leaves, k), np.int32)
    valid = np.zeros((num_leaves, k), np.float32)
    for i, p in enumerate(paths[:num_leaves]):
        idx[i, :len(p)] = p
        valid[i, :len(p)] = 1.0
    return idx, valid


def leaf_row_order(leaf_id: torch.Tensor, num_leaves: int):
    """(the rows sorted by leaf, stable; (L + 1,) host offsets of each
    leaf's rows in that order): one host read."""
    lid = leaf_id.to(torch.int64)
    order = torch.argsort(lid, stable=True)
    counts = torch.bincount(lid, minlength=num_leaves).cpu().numpy()
    return order, np.concatenate([[0], np.cumsum(counts)])


def new_linear_carry(feat_idx, num_leaves: int, device):
    """Zeroed float64 (L, k+1, k+1) A and (L, k+1) b of (L, k) path planes."""
    k = np.asarray(feat_idx).shape[1]
    return (torch.zeros((num_leaves, k + 1, k + 1), dtype=torch.float64, device=device),
            torch.zeros((num_leaves, k + 1), dtype=torch.float64, device=device))


def _fold_leaves(a, b, column, grad, hess, select, leaf_id, feat_idx, feat_valid, value_lut,
                 num_leaves: int) -> None:
    """Add the normal equations of the rows of ``leaf_id`` into the float64
    carries ``a``, ``b``: per leaf one matmul over its rows (sorted by
    leaf, stable) and its path columns, read by ``column(f, rows)``."""
    dev = grad.device
    fi = np.asarray(feat_idx)
    kv = np.asarray(feat_valid).sum(axis=1).astype(np.int64)
    L = fi.shape[0]
    order, starts = leaf_row_order(leaf_id, num_leaves)
    hw = (hess * select).double()
    gw = (grad * select).double()
    fi_dev = torch.from_numpy(fi.astype(np.int64)).to(dev)
    for leaf in range(min(L, num_leaves)):
        lo, hi = int(starts[leaf]), int(starts[leaf + 1])
        if hi == lo:
            continue
        rows = order[lo:hi]
        kl = int(kv[leaf])
        xt = torch.ones((kl + 1, hi - lo), dtype=torch.float64, device=dev)
        if kl:
            f = fi_dev[leaf, :kl, None]
            xt[1:] = value_lut[f, column(f, rows[None, :])].double()
        h, g = hw[rows], gw[rows]
        a[leaf, :kl + 1, :kl + 1] += (xt * h) @ xt.T
        b[leaf, :kl + 1] += xt @ g


def linear_fit_stats(column, grad, hess, select, leaf_id, feat_idx, feat_valid, value_lut,
                     num_leaves: int):
    """The per-leaf normal equations: (L, k+1, k+1) A and (L, k+1) b,
    float32 on the rows' device (float64 sums rounded once).

    ``column(f, rows)``: the int64 bins of features ``f`` at ``rows``
    (broadcast); grad/hess/select (N,) float32; leaf_id (N,) the grower's
    partition; feat_idx/feat_valid (L, k) host arrays; value_lut (F, B)
    float32 on the device."""
    a, b = new_linear_carry(feat_idx, np.asarray(feat_idx).shape[0], grad.device)
    _fold_leaves(a, b, column, grad, hess, select, leaf_id, feat_idx, feat_valid, value_lut,
                 num_leaves)
    return a.float(), b.float()


def linear_stats_chunk(a, b, column, grad, hess, select, leaf_id, start: int, stop: int,
                       feat_idx, feat_valid, value_lut, num_leaves: int) -> None:
    """Fold rows [start, stop) into the float64 carries ``a``, ``b``
    (``new_linear_carry``): the out-of-core chunk of ``linear_fit_stats``
    (JAX tree/linear.py:163).  ``column(f, rows)`` reads the chunk's bins
    at chunk-local rows; the vectors are the full (N,) ones."""
    _fold_leaves(a, b, column, grad[start:stop], hess[start:stop], select[start:stop],
                 leaf_id[start:stop], feat_idx, feat_valid, value_lut, num_leaves)


def solve_linear_leaves(a, bv, feat_valid, leaf_cnt, linear_lambda, lambda_l2):
    """Batched ridge solve of (A + D) w = -b per leaf, one float64
    Cholesky on A's device.  Returns (w (L, k+1) float32, ok (L,) bool):
    a leaf whose matrix is not positive definite or whose solution is not
    finite, with no valid feature, or with no more selected rows than
    coefficients keeps its constant output (w = 0)."""
    a = torch.as_tensor(a).double()
    bv = torch.as_tensor(bv, device=a.device).double()
    fv = torch.as_tensor(np.asarray(feat_valid, np.float32), device=a.device)
    cnt = torch.as_tensor(np.asarray(leaf_cnt, np.float32), device=a.device)
    L, k1 = bv.shape
    kv = fv.sum(dim=1)
    diag = torch.cat([torch.full((L, 1), float(np.float32(lambda_l2)), device=a.device),
                      torch.where(fv > 0, float(np.float32(linear_lambda)), 1.0)], dim=1)
    chol, info = torch.linalg.cholesky_ex(a + torch.diag_embed(diag.double()))
    y = torch.linalg.solve_triangular(chol, -bv[..., None], upper=False)
    w = torch.linalg.solve_triangular(chol.mT, y, upper=True)[..., 0]
    ok = (info == 0) & torch.isfinite(w).all(dim=1) & (kv > 0) & (cnt > kv + 1.0)
    return torch.where(ok[:, None], w, 0.0).float(), ok


def apply_linear(out, lid, feat, valid, coeff, const, is_lin, x_of):
    """One tree's outputs with linear leaves: ``out`` (N,) float32 holds
    the constant output of each row's leaf ``lid`` (N,) and is rewritten
    in place where the leaf is linear, by const + coeff · x summed in
    float64 and rounded once.  ``feat``/``valid``/``coeff`` are the tree's
    (L, k) planes, ``const``/``is_lin`` (L,); ``x_of(feats, lo, hi)`` gives
    rows [lo, hi)'s (R, k) float32 values of ``feats`` (R, k).  A row with
    a NaN path feature keeps the constant."""
    n = lid.shape[0]
    for lo in range(0, n, ROW_STEP):
        hi = min(n, lo + ROW_STEP)
        lv = lid[lo:hi]
        fv = valid[lv]
        x = x_of(feat[lv], lo, hi) * fv
        nan = torch.isnan(x)
        bad = (nan & (fv > 0)).any(dim=1)
        x = torch.where(nan, 0.0, x).double()
        lin = (const[lv].double() + (coeff[lv].double() * x).sum(dim=1)).float()
        out[lo:hi] = torch.where(is_lin[lv] & ~bad, lin, out[lo:hi])
    return out


def binned_values(column, value_lut):
    """``x_of`` of ``apply_linear`` over bins: a feature's bin at each row
    through the value table."""
    def x_of(feats, lo, hi):
        rows = torch.arange(lo, hi, device=feats.device)[:, None]
        return value_lut[feats, column(feats, rows)]

    return x_of


def linear_leaf_scores(column, leaf_id, feat_idx, feat_valid, coeff, const, fallback, is_lin,
                       value_lut):
    """(N,) float32 outputs of one freshly grown linear tree at the rows
    of its partition ``leaf_id``: the linear model where the leaf has one,
    ``fallback`` (the constant) otherwise — the train-score update.  The
    (L, k) / (L,) planes are tensors on the rows' device."""
    lid = leaf_id.to(torch.int64)
    out = fallback[lid]
    return apply_linear(out, lid, feat_idx, feat_valid, coeff, const, is_lin,
                        binned_values(column, value_lut))


def linear_scores_chunk(column, leaf_id, start: int, stop: int, feat_idx, feat_valid, coeff, const,
                        fallback, is_lin, value_lut):
    """Rows [start, stop)'s outputs of a freshly grown linear tree: the
    out-of-core chunk of ``linear_leaf_scores`` (JAX tree/linear.py:221);
    ``column`` reads the chunk's bins at chunk-local rows."""
    return linear_leaf_scores(column, leaf_id[start:stop], feat_idx, feat_valid, coeff, const,
                              fallback, is_lin, value_lut)
