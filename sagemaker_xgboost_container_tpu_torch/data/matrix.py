"""DataMatrix: the in-memory dataset.

Dense float32 numpy on the host with NaN as the missing marker. It moves to
the device only after binning (``binning.py``), as a compact uint8/uint16
bin-index matrix. Sparse inputs densify with NaN fill, so an absent entry
keeps XGBoost's missing-value semantics rather than becoming 0.
"""

import numpy as np
import scipy.sparse as sp

from ..toolkit import exceptions as exc


class DataMatrix:
    """Features + labels + optional per-row weights and ranking groups."""

    def __init__(self, features, labels=None, weights=None, groups=None, feature_names=None):
        if sp.issparse(features):
            features = _densify_with_nan(features.tocsr())
        features = np.asarray(features, dtype=np.float32)
        if features.ndim != 2:
            raise exc.AlgorithmError(
                "DataMatrix features must be 2-D, got shape {}".format(features.shape)
            )
        self.features = features
        self.labels = None if labels is None else np.asarray(labels, dtype=np.float32).reshape(-1)
        self.weights = None if weights is None else np.asarray(weights, dtype=np.float32).reshape(-1)
        self.groups = None if groups is None else np.asarray(groups, dtype=np.int32).reshape(-1)
        self.feature_names = list(feature_names) if feature_names is not None else None

        if self.labels is not None and len(self.labels) != self.num_row:
            raise exc.UserError(
                "Label count {} does not match row count {}".format(len(self.labels), self.num_row)
            )
        if self.weights is not None and len(self.weights) != self.num_row:
            raise exc.UserError(
                "Weight count {} does not match row count {}".format(
                    len(self.weights), self.num_row
                )
            )
        if self.groups is not None and int(self.groups.sum()) != self.num_row:
            raise exc.UserError(
                "Group sizes sum to {} but the data has {} rows".format(
                    int(self.groups.sum()), self.num_row
                )
            )

    @property
    def num_row(self):
        return self.features.shape[0]

    @property
    def num_col(self):
        return self.features.shape[1]

    def get_label(self):
        return self.labels if self.labels is not None else np.empty(0, dtype=np.float32)

    def get_weight(self):
        if self.weights is None:
            return np.ones(self.num_row, dtype=np.float32)
        return self.weights

    def slice(self, row_indices):
        """Row subset (k-fold CV), keeping labels and weights."""
        row_indices = np.asarray(row_indices)
        return DataMatrix(
            self.features[row_indices],
            labels=None if self.labels is None else self.labels[row_indices],
            weights=None if self.weights is None else self.weights[row_indices],
            feature_names=self.feature_names,
        )

    def pad_features(self, num_col):
        """Widen with all-missing columns (serving: model trained on more cols)."""
        if num_col <= self.num_col:
            return self
        pad = np.full((self.num_row, num_col - self.num_col), np.nan, dtype=np.float32)
        return DataMatrix(
            np.concatenate([self.features, pad], axis=1),
            labels=self.labels,
            weights=self.weights,
            groups=self.groups,
            feature_names=self.feature_names,
        )

    def concat(self, other):
        """Row-wise concatenation (the k-fold CV train + validation merge)."""
        d = max(self.num_col, other.num_col)
        a, b = self.pad_features(d), other.pad_features(d)

        def _cat(x, y):
            if x is None and y is None:
                return None
            if x is None:
                x = np.zeros(a.num_row, dtype=y.dtype)
            if y is None:
                y = np.zeros(b.num_row, dtype=x.dtype)
            return np.concatenate([x, y])

        return DataMatrix(
            np.concatenate([a.features, b.features], axis=0),
            labels=_cat(a.labels, b.labels),
            weights=_cat(a.weights, b.weights),
            feature_names=self.feature_names,
        )


def _densify_with_nan(csr):
    """CSR -> dense float32 where absent entries become NaN (missing)."""
    out = np.full(csr.shape, np.nan, dtype=np.float32)
    rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
    out[rows, csr.indices] = csr.data
    return out
