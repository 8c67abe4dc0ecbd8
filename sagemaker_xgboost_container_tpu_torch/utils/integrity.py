"""Model-artifact integrity for serving: content digests, manifest sidecars,
structural validation.

* **digests**: sha256 over a file's exact bytes (``file_digest``) and over a
  Forest's trees in a canonical packed byte layout (``forest_digest``);
* **manifest sidecars**: a versioned JSON file beside a model file
  (``<name>.manifest``) with the file's digest and byte count. A serving
  load digest-verifies any artifact whose manifest traveled with it;
* **structural validation** (``validate_model``): children in range,
  finite thresholds and leaf values, feature ids in range, consistent tree
  bookkeeping, the invariants the predict traversal assumes.

The manifest schema and ``forest_digest`` are the JAX package's: a manifest
written by either package verifies in the other, and one model file has
one forest digest in both.
"""

import hashlib
import json
import logging
import os

import numpy as np

logger = logging.getLogger(__name__)

MANIFEST_SUFFIX = ".manifest"
MANIFEST_VERSION = 1


class IntegrityError(RuntimeError):
    """A model artifact failed digest or structural verification."""


# ------------------------------------------------------------------ digests
def file_digest(path, chunk_size=1 << 20):
    """Streaming sha256 of a file's exact bytes."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(chunk_size), b""):
            h.update(chunk)
    return h.hexdigest()


# the canonical (name, dtype) layout of one tree's arrays, in this order.
# Float fields hash their raw IEEE bytes, so two trees agree only when they
# are bit-identical
_TREE_DIGEST_FIELDS = (
    ("feature", np.int32),
    ("threshold", np.float32),
    ("default_left", np.uint8),
    ("left", np.int32),
    ("right", np.int32),
    ("value", np.float32),
    ("base_weight", np.float32),
    ("gain", np.float32),
    ("sum_hess", np.float32),
)


def forest_digest(model):
    """sha256 over a Forest's trees in canonical packed bytes: ``tree_info``
    (i32) and ``iteration_indptr`` (i64), then each tree's fields in
    ``_TREE_DIGEST_FIELDS`` order and dtypes followed by its node count
    (i64), so (3 nodes + 5) never collides with (5 + 3). Before the node
    count come the categorical nodes in id order: node id and set size
    (i64), then the set (i64), so {1: [2]} never collides with
    {1: [], 2: []}."""
    h = hashlib.sha256()
    h.update(np.asarray(model.tree_info, np.int32).tobytes())
    h.update(np.asarray(model.iteration_indptr, np.int64).tobytes())
    for tree in model.trees:
        for name, dtype in _TREE_DIGEST_FIELDS:
            h.update(np.ascontiguousarray(np.asarray(getattr(tree, name), dtype)).tobytes())
        categories = getattr(tree, "categories", None) or {}
        for node in sorted(categories):
            cats = np.ascontiguousarray(np.asarray(categories[node], np.int64))
            h.update(np.asarray([node, cats.size], np.int64).tobytes())
            h.update(cats.tobytes())
        h.update(np.asarray([tree.num_nodes], np.int64).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------- manifests
def manifest_path(model_path):
    return str(model_path) + MANIFEST_SUFFIX


def build_manifest(model_path, iteration=None):
    """The manifest dict of a model file (the JAX package's schema)."""
    manifest = {
        "manifest_version": MANIFEST_VERSION,
        "sha256": file_digest(model_path),
        "bytes": os.path.getsize(model_path),
    }
    if iteration is not None:
        manifest["iteration"] = int(iteration)
    return manifest


def write_manifest(model_path, iteration=None):
    """Write ``model_path``'s sidecar manifest (sorted-key JSON to a temp
    file, renamed into place). -> the manifest dict."""
    manifest = build_manifest(model_path, iteration=iteration)
    target = manifest_path(model_path)
    # dot-prefixed temp: the serving loader skips dotfiles, so a crash here
    # never leaves a file that a model-dir scan would try to load
    tmp = os.path.join(os.path.dirname(target) or ".", "." + os.path.basename(target) + ".tmp")
    try:
        with open(tmp, "w") as f:
            json.dump(manifest, f, sort_keys=True)
        os.replace(tmp, target)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return manifest


def read_manifest(model_path):
    """The manifest of ``model_path``'s sidecar, or None: when there is none
    (older models, models trained elsewhere), or when it does not parse or
    lacks a digest or a usable byte count (with a warning; the load then
    falls back to parse and structural checks)."""
    path = manifest_path(model_path)
    try:
        with open(path, "r") as f:
            manifest = json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as e:
        logger.warning("ignoring unreadable manifest %s: %s", path, e)
        return None
    if not isinstance(manifest, dict) or not isinstance(manifest.get("sha256"), str):
        logger.warning("ignoring malformed manifest %s (no sha256)", path)
        return None
    if manifest.get("bytes") is not None:
        try:
            manifest["bytes"] = int(manifest["bytes"])
        except (TypeError, ValueError):
            logger.warning("ignoring malformed manifest %s (bad byte count)", path)
            return None
    return manifest


def verify_file_against_manifest(model_path, manifest):
    """Raise IntegrityError when the file's bytes disagree with ``manifest``
    (from :func:`read_manifest`)."""
    size = manifest.get("bytes")
    if size is not None and os.path.getsize(model_path) != int(size):
        raise IntegrityError("{}: byte count {} != manifest {}".format(
            model_path, os.path.getsize(model_path), size))
    actual = file_digest(model_path)
    if actual != manifest["sha256"]:
        raise IntegrityError("{}: sha256 {} != manifest {}".format(
            model_path, actual, manifest["sha256"]))


def check_model_file(model_path):
    """-> ``"verified"`` when a manifest travels with ``model_path`` and
    its digest matches, ``"no_manifest"`` when none (usable) does. Raises
    IntegrityError on a mismatch."""
    manifest = read_manifest(model_path)
    if manifest is None:
        return "no_manifest"
    verify_file_against_manifest(model_path, manifest)
    return "verified"


# --------------------------------------------------------- model validation
def _require(cond, tree_idx, message):
    if not cond:
        raise IntegrityError("tree {}: {}".format(tree_idx, message))


def validate_model(model):
    """Structural validation of a loaded Forest or LinearModel (or a list
    of them, an ensemble); raises IntegrityError. Every tree's arrays have one length,
    split children lie inside the tree and are never the node itself,
    thresholds (at numerical splits: a categorical node routes by its set,
    and some exporters leave NaN there) and leaf values are finite, split
    feature ids are in range,
    and ``tree_info`` / ``iteration_indptr`` match the tree list. A linear
    model's weights are finite. Other objects (a script-mode model_fn's)
    pass."""
    if isinstance(model, list):
        for m in model:
            validate_model(m)
        return
    trees = getattr(model, "trees", None)
    if trees is None:
        weights = getattr(model, "weights", None)
        if weights is not None and not np.all(np.isfinite(np.asarray(weights))):
            raise IntegrityError("linear model has non-finite weights")
        return
    num_feature = int(getattr(model, "num_feature", 0) or 0)
    num_group = int(getattr(model, "num_output_group", 1) or 1)
    tree_info = list(model.tree_info)
    indptr = list(model.iteration_indptr)
    if len(tree_info) != len(trees):
        raise IntegrityError("tree_info length {} != {} trees".format(len(tree_info), len(trees)))
    if any(not 0 <= int(c) < num_group for c in tree_info):
        raise IntegrityError(
            "tree_info class ids out of range for {} output group(s)".format(num_group))
    if (not indptr or indptr[0] != 0 or indptr[-1] != len(trees)
            or any(b < a for a, b in zip(indptr, indptr[1:]))):
        raise IntegrityError(
            "iteration_indptr is not a monotone partition of {} trees".format(len(trees)))
    for i, tree in enumerate(trees):
        n = int(tree.num_nodes)
        _require(n >= 1, i, "empty tree")
        for field in ("threshold", "default_left", "left", "right", "value"):
            _require(len(np.asarray(getattr(tree, field))) == n, i,
                     "field {!r} length != {} nodes".format(field, n))
        left = np.asarray(tree.left, np.int64)
        right = np.asarray(tree.right, np.int64)
        is_leaf = left < 0
        _require(bool(np.all((right < 0) == is_leaf)), i,
                 "split nodes must have both children (left/right leaf flags disagree)")
        split = ~is_leaf
        if np.any(split):
            ids = np.nonzero(split)[0]
            _require(bool(np.all((left[split] < n) & (right[split] < n))), i,
                     "child index out of range (>= {} nodes)".format(n))
            _require(bool(np.all((left[split] != ids) & (right[split] != ids))), i,
                     "split node is its own child")
            numeric_split = split.copy()
            for node in getattr(tree, "categories", None) or {}:
                if 0 <= int(node) < n:
                    numeric_split[int(node)] = False
            _require(bool(np.all(np.isfinite(np.asarray(tree.threshold)[numeric_split]))), i,
                     "non-finite split threshold")
            feature = np.asarray(tree.feature, np.int64)[split]
            _require(bool(np.all(feature >= 0)), i, "negative split feature id")
            if num_feature > 0:
                _require(bool(np.all(feature < num_feature)), i,
                         "split feature id >= num_feature {}".format(num_feature))
        _require(bool(np.all(np.isfinite(np.asarray(tree.value)[is_leaf]))), i,
                 "non-finite leaf value")
