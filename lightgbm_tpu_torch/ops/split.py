"""Vectorized best-split search over (S, F, B, 3) histograms.

PyTorch counterpart of lightgbm_tpu/ops/split.py
(FeatureHistogram::FindBestThreshold*, feature_histogram.hpp:71-198,
253-387): every (feature, zero/missing placement, threshold) cell is
evaluated at once from prefix sums, in float32, with the same operation
order and the same tie preferences as the JAX package —

- features: the lowest index wins ties (ArrayArgs::ArgMax);
- placements: zero-left before natural before zero-right;
- thresholds: the highest wins for zero-left/natural (right-to-left
  scans), the lowest for zero-right.

The JAX package ``vmap``s the per-leaf search; here the leaf batch is a
written-out leading dimension S.  Per-element arithmetic does not depend
on S, so a leaf's result is the same alone or in a batch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NEG_INF = float("-inf")


class SplitHyper(NamedTuple):
    """Split-relevant hyperparameters (TreeConfig, config.h:189-234), as
    float32 numpy scalars."""

    lambda_l1: np.float32
    lambda_l2: np.float32
    min_data_in_leaf: np.float32
    min_sum_hessian_in_leaf: np.float32
    min_gain_to_split: np.float32

    @classmethod
    def from_config(cls, config) -> "SplitHyper":
        return cls(*(np.float32(getattr(config, k)) for k in cls._fields))


class FeatureMeta(NamedTuple):
    """Per-feature metadata (FeatureMetainfo, hpp:14-21) as tensors."""

    num_bins: torch.Tensor  # (F,) int64
    default_bin: torch.Tensor  # (F,) int64
    is_categorical: torch.Tensor  # (F,) bool

    @classmethod
    def from_dataset(cls, dataset, device="cpu") -> "FeatureMeta":
        from ..io.binning import CATEGORICAL

        ms = dataset.bin_mappers
        return cls(
            torch.tensor([m.num_bin for m in ms], dtype=torch.int64, device=device),
            torch.tensor([m.default_bin for m in ms], dtype=torch.int64, device=device),
            torch.tensor([m.bin_type == CATEGORICAL for m in ms], dtype=torch.bool,
                         device=device),
        )


class SplitResult(NamedTuple):
    """Best split per leaf (SplitInfo, split_info.hpp:17); each field (S,)."""

    gain: torch.Tensor  # already min_gain_shift-subtracted
    feature: torch.Tensor
    threshold_bin: torch.Tensor
    default_bin_for_zero: torch.Tensor
    left_sum_g: torch.Tensor
    left_sum_h: torch.Tensor
    left_cnt: torch.Tensor
    right_sum_g: torch.Tensor
    right_sum_h: torch.Tensor
    right_cnt: torch.Tensor
    left_output: torch.Tensor
    right_output: torch.Tensor


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def leaf_split_gain(sum_g, sum_h, l1, l2):
    """GetLeafSplitGain (feature_histogram.hpp:230-236)."""
    reg = torch.clamp(torch.abs(sum_g) - l1, min=0.0)
    return reg * reg / (sum_h + l2)


def leaf_output(sum_g, sum_h, l1, l2):
    """CalculateSplittedLeafOutput (feature_histogram.hpp:244-249)."""
    reg = torch.clamp(torch.abs(sum_g) - l1, min=0.0)
    return -torch.sign(sum_g) * reg / (sum_h + l2)


def leaf_output_np(sum_g, sum_h, l1, l2):
    """leaf_output in float32 numpy (host-side bookkeeping)."""
    g = np.asarray(sum_g, np.float32)
    h = np.asarray(sum_h, np.float32)
    reg = np.maximum(np.abs(g) - np.float32(l1), np.float32(0.0))
    return (-np.sign(g) * reg / (h + np.float32(l2))).astype(np.float32)


def _argmax_prefer_high(x):
    """argmax returning the HIGHEST index among ties along the last axis."""
    n = x.shape[-1]
    return n - 1 - torch.argmax(torch.flip(x, dims=[-1]), dim=-1)


def _take(x, idx):
    """x (S, F, K, ...) indexed along axis 2 by idx (S, F)."""
    ix = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    ix = ix.expand(idx.shape + (1,) + x.shape[3:])
    return torch.gather(x, 2, ix).squeeze(2)


def best_split_per_feature(hist, sum_g, sum_h, num_data, meta: FeatureMeta,
                           hyper: SplitHyper, feature_mask, use_missing: bool = True,
                           has_categorical: bool = True):
    """Per-feature best split for S leaves at once.

    hist (S, F, B, 3) f32; sum_g/sum_h/num_data (S,) leaf totals;
    feature_mask (F,) 0/1.  Returns gain_f (S, F), thr_f (S, F),
    dbz_f (S, F), left_f (S, F, 3)."""
    S, F, b, _ = hist.shape
    l1, l2 = _f32(hyper.lambda_l1, hist), _f32(hyper.lambda_l2, hist)
    min_cnt = _f32(hyper.min_data_in_leaf, hist)
    min_hess = _f32(hyper.min_sum_hessian_in_leaf, hist)
    sg = sum_g[:, None, None]
    sh = sum_h[:, None, None]
    sn = num_data[:, None, None]
    gain_shift = leaf_split_gain(sum_g, sum_h, l1, l2)
    min_gain_shift = (gain_shift + _f32(hyper.min_gain_to_split, hist))[:, None, None]

    cum = torch.cumsum(hist, dim=2)  # (S, F, B, 3)
    db = meta.default_bin  # (F,)
    nb = meta.num_bins
    hist_db = _take(hist, db[None, :].expand(S, F))  # (S, F, 3)
    thr = torch.arange(b - 1, device=hist.device)
    db_gt_t = (db[:, None] > thr[None, :]).to(torch.float32)  # (F, B-1)
    db_le_t = 1.0 - db_gt_t

    base = cum[:, :, : b - 1, :]
    left_zl = base + db_gt_t[None, :, :, None] * hist_db[:, :, None, :]
    left_zr = base - db_le_t[None, :, :, None] * hist_db[:, :, None, :]
    thr_ok = thr[None, :] <= nb[:, None] - 2  # (F, B-1)

    def eval_placement(left, extra_valid):
        lg, lh, lc = left[..., 0], left[..., 1], left[..., 2]
        rg, rh, rc = sg - lg, sh - lh, sn - lc
        valid = (extra_valid[None] & (lc >= min_cnt) & (rc >= min_cnt)
                 & (lh >= min_hess) & (rh >= min_hess) & thr_ok[None])
        gain = leaf_split_gain(lg, lh, l1, l2) + leaf_split_gain(rg, rh, l1, l2)
        return torch.where(valid & (gain > min_gain_shift), gain, NEG_INF)  # (S, F, B-1)

    always = torch.ones((F, b - 1), dtype=torch.bool, device=hist.device)
    if use_missing:
        interior = (db > 0) & (db < nb - 1)
        gain_zl = eval_placement(left_zl, thr[None, :] != db[:, None] - 1)
        gain_nat = eval_placement(base, interior[:, None] & always)
        gain_zr = eval_placement(left_zr, (nb[:, None] > 2) & (thr[None, :] != db[:, None]))
        flat = torch.cat([torch.flip(gain_zl, [2]), torch.flip(gain_nat, [2]), gain_zr], dim=2)
        idx = torch.argmax(flat, dim=2)  # (S, F)
        best_gain_f = torch.gather(flat, 2, idx[..., None])[..., 0]
        pl = idx // (b - 1)
        off = idx % (b - 1)
        best_thr_f = torch.where(pl == 2, off, b - 2 - off)
        best_dbz_f = torch.where(pl == 0, torch.zeros_like(pl),
                                 torch.where(pl == 1, db[None, :].expand(S, F),
                                             (nb - 1)[None, :].expand(S, F)))
        left_all = torch.cat([left_zl, base, left_zr], dim=2)
        best_left_f = _take(left_all, pl * (b - 1) + best_thr_f)
    else:
        gain_nat = eval_placement(base, always)
        t_idx = _argmax_prefer_high(gain_nat)
        best_gain_f = torch.gather(gain_nat, 2, t_idx[..., None])[..., 0]
        best_thr_f = t_idx
        best_dbz_f = db[None, :].expand(S, F).clone()
        best_left_f = _take(base, t_idx)

    fmask = (feature_mask > 0)[None, :]
    mgs = min_gain_shift[:, :, 0]  # (S, 1)
    if has_categorical:
        # categorical one-vs-rest (FindBestThresholdCategorical,
        # hpp:100-198): left = exactly bin t
        cg, ch, cc = hist[..., 0], hist[..., 1], hist[..., 2]  # (S, F, B)
        og, oh, oc = sg - cg, sh - ch, sn - cc
        cat_valid = ((cc >= min_cnt) & (oc >= min_cnt) & (ch >= min_hess) & (oh >= min_hess)
                     & (torch.arange(b, device=hist.device)[None, :] <= nb[:, None] - 1)[None])
        cat_gain = leaf_split_gain(cg, ch, l1, l2) + leaf_split_gain(og, oh, l1, l2)
        cat_gain = torch.where(cat_valid & (cat_gain > min_gain_shift), cat_gain, NEG_INF)
        cat_t = _argmax_prefer_high(cat_gain)
        cat_best = torch.gather(cat_gain, 2, cat_t[..., None])[..., 0]
        cat_left = _take(hist, cat_t)
        is_cat = meta.is_categorical[None, :]
        best_gain_f = torch.where(is_cat, cat_best, best_gain_f)
        best_thr_f = torch.where(is_cat, cat_t, best_thr_f)
        best_dbz_f = torch.where(is_cat, db[None, :].expand(S, F), best_dbz_f)
        best_left_f = torch.where(is_cat[..., None], cat_left, best_left_f)
    best_gain_f = torch.where(fmask, best_gain_f, NEG_INF)
    best_gain_f = torch.where(torch.isfinite(best_gain_f), best_gain_f - mgs, NEG_INF)
    return best_gain_f, best_thr_f, best_dbz_f, best_left_f


def finalize_split(gain_f, thr_f, dbz_f, left_f, sum_g, sum_h, num_data,
                   hyper: SplitHyper) -> SplitResult:
    """Argmax over features (first/lowest index wins ties) and SplitInfo
    assembly, per leaf."""
    l1, l2 = _f32(hyper.lambda_l1, gain_f), _f32(hyper.lambda_l2, gain_f)
    fbest = torch.argmax(gain_f, dim=1)  # (S,)
    sel = fbest[:, None]
    left = torch.gather(left_f, 1, sel[..., None].expand(-1, 1, 3))[:, 0]
    lg, lh, lc = left[:, 0], left[:, 1], left[:, 2]
    rg, rh, rc = sum_g - lg, sum_h - lh, num_data - lc
    return SplitResult(
        gain=torch.gather(gain_f, 1, sel)[:, 0],
        feature=fbest,
        threshold_bin=torch.gather(thr_f, 1, sel)[:, 0],
        default_bin_for_zero=torch.gather(dbz_f, 1, sel)[:, 0],
        left_sum_g=lg, left_sum_h=lh, left_cnt=lc,
        right_sum_g=rg, right_sum_h=rh, right_cnt=rc,
        left_output=leaf_output(lg, lh, l1, l2),
        right_output=leaf_output(rg, rh, l1, l2),
    )


def best_split_all_features(hist, sum_g, sum_h, num_data, meta, hyper, feature_mask,
                            use_missing: bool = True,
                            has_categorical: bool = True) -> SplitResult:
    """Best split across every feature, per leaf of the batch."""
    gain_f, thr_f, dbz_f, left_f = best_split_per_feature(
        hist, sum_g, sum_h, num_data, meta, hyper, feature_mask, use_missing,
        has_categorical)
    return finalize_split(gain_f, thr_f, dbz_f, left_f, sum_g, sum_h, num_data, hyper)
