"""Repeated k-fold splits for cross-validation, in numpy.

The JAX package splits with sklearn's ``RepeatedKFold`` and
``RepeatedStratifiedKFold``; the GPU machine has no sklearn, so these are
their algorithms written out. Given the same ``np.random.RandomState`` (or
None: numpy's global one, as sklearn takes it), they draw the same numbers
in the same order and yield the same (train, test) index arrays, both
sorted ascending.
"""

import warnings

import numpy as np


def _random_state(random_state):
    """sklearn's check_random_state for None, an int or a RandomState."""
    if random_state is None:
        return np.random.mtrand._rand
    if isinstance(random_state, np.random.RandomState):
        return random_state
    return np.random.RandomState(random_state)


def _split_by_test_folds(test_folds, n_splits):
    """Fold ids per row -> (train, test) index pairs, fold by fold."""
    indices = np.arange(len(test_folds))
    for i in range(n_splits):
        test = test_folds == i
        yield indices[~test], indices[test]


def _check_splits(n_splits, n_samples):
    if n_splits > n_samples:
        raise ValueError(
            "Cannot have number of splits n_splits={0} greater than the number of "
            "samples: n_samples={1}.".format(n_splits, n_samples))


def _kfold_test_folds(n_samples, n_splits, rng):
    """KFold(shuffle=True): a shuffled arange cut into n_splits runs, the
    first n_samples % n_splits one longer."""
    indices = np.arange(n_samples)
    rng.shuffle(indices)
    sizes = np.full(n_splits, n_samples // n_splits, dtype=int)
    sizes[: n_samples % n_splits] += 1
    test_folds = np.empty(n_samples, dtype=int)
    test_folds[indices] = np.repeat(np.arange(n_splits), sizes)
    return test_folds


def _target_type(y):
    if y.dtype.kind == "f" and np.any(y != y.astype(int)):
        return "continuous"
    return "binary" if len(np.unique(y)) <= 2 else "multiclass"


def _stratified_test_folds(y, n_splits, rng):
    """StratifiedKFold(shuffle=True): each class's rows dealt to the folds
    round robin over the sorted labels, then shuffled within the class."""
    y = np.asarray(y)
    kind = _target_type(y)
    if kind not in ("binary", "multiclass"):
        raise ValueError("Supported target types are: ('binary', 'multiclass'). Got {!r} "
                         "instead.".format(kind))
    y = y.ravel()
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    # classes numbered by first appearance
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    y_counts = np.bincount(y_encoded)
    if np.all(n_splits > y_counts):
        raise ValueError("n_splits=%d cannot be greater than the number of members in each "
                         "class." % n_splits)
    if n_splits > np.min(y_counts):
        warnings.warn("The least populated class in y has only %d members, which is less "
                      "than n_splits=%d." % (np.min(y_counts), n_splits), UserWarning)
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::n_splits], minlength=n_classes)
                             for i in range(n_splits)])
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    return test_folds


class RepeatedKFold:
    """``n_repeats`` shuffled k-fold splits of the rows."""

    def __init__(self, n_splits=5, n_repeats=10, random_state=None):
        self.n_splits, self.n_repeats, self.random_state = n_splits, n_repeats, random_state

    def split(self, X, y=None):
        n = len(X)
        rng = _random_state(self.random_state)
        for _ in range(self.n_repeats):
            _check_splits(self.n_splits, n)
            yield from _split_by_test_folds(_kfold_test_folds(n, self.n_splits, rng),
                                            self.n_splits)


class RepeatedStratifiedKFold(RepeatedKFold):
    """``n_repeats`` shuffled k-fold splits that keep each class's share of
    the rows in every fold."""

    def split(self, X, y=None):
        rng = _random_state(self.random_state)
        for _ in range(self.n_repeats):
            _check_splits(self.n_splits, len(X))
            yield from _split_by_test_folds(_stratified_test_folds(y, self.n_splits, rng),
                                            self.n_splits)
