"""Device operations: the packed-matrix kernels (pkernels), the grower
(pgrow), split search (split) and prediction (predict)."""
