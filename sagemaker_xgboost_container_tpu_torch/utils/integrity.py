"""State integrity: content digests, manifest sidecars, resume validation,
model validation.

* **digests**: sha256 over a file's exact bytes (``file_digest``) and over a
  Forest's trees in a canonical packed byte layout (``forest_digest``);
* **manifest sidecars**: a versioned JSON file beside a model file
  (``<name>.manifest``) with the file's digest and byte count, and for a
  checkpoint its iteration and the job's config fingerprint; a final model
  also carries the learning-curve summary and the drift baseline when
  ``SM_MODEL_TELEMETRY`` was on. ``training/checkpointing`` writes them
  beside every checkpoint, ``write_manifest`` beside the final model; a
  resume and a serving load digest-verify any artifact whose manifest
  traveled with it;
* **resume validation** (``validate_resume``): a checkpoint's fingerprint
  against the live job's; a difference warns, and under
  ``SM_RESUME_STRICT=true`` refuses (resuming under another binning or
  objective silently forks the model);
* **structural validation** (``validate_model``): children in range,
  finite thresholds and leaf values, feature ids in range, consistent tree
  bookkeeping, the invariants the predict traversal assumes.

The manifest schema, the fingerprint's keys and ``forest_digest`` are the
JAX package's: a manifest written by either package verifies in the other,
and one model file has one forest digest in both. The port has no jax, and
writes ``"jax_version": "absent"`` (what the JAX package writes where jax
does not import); it adds ``torch_version``, which the JAX package's
comparison does not read. So a resume across packages names the runtime
change in ``jax_version``, in both directions.
"""

import hashlib
import json
import logging
import os

import numpy as np

logger = logging.getLogger(__name__)

MANIFEST_SUFFIX = ".manifest"
MANIFEST_VERSION = 1

RESUME_STRICT_ENV = "SM_RESUME_STRICT"

# config keys whose disagreement between a checkpoint and the live job means
# the resumed rounds would train under other split candidates or another
# loss; version and world-size drift are reported too. The JAX package's
# keys, then the port's own runtime, compared only where both fingerprints
# carry it
_FINGERPRINT_KEYS = (
    "objective",
    "tree_method",
    "max_bin",
    "max_depth",
    "world_size",
    "jax_version",
    "package_version",
    "torch_version",
)


class IntegrityError(RuntimeError):
    """A model artifact failed digest or structural verification."""


def resume_strict():
    from .envconfig import env_bool

    return env_bool(RESUME_STRICT_ENV, False)


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
    {1: [], 2: []}. A linear model (gblinear, no trees) digests its weights
    and bias (f32), after the bytes ``linear``: the JAX package's digest."""
    h = hashlib.sha256()
    if getattr(model, "trees", None) is None:
        h.update(b"linear")
        for name in ("weights", "bias"):
            h.update(np.ascontiguousarray(
                np.asarray(getattr(model, name, np.zeros(0)), np.float32)).tobytes())
        return h.hexdigest()
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


def build_manifest(model_path, iteration=None, fingerprint=None, digest=None, size=None,
                   membership_log=None, quarantine=None, learning=None, drift_baseline=None):
    """The manifest dict of a model file: the JAX package's schema, which
    every writer goes through. ``digest`` / ``size`` stand for the on-disk
    read where the caller measured the temp file before renaming it.
    ``membership_log`` and ``quarantine`` are the JAX package's multi-host
    and streaming-ingest records, None on one host. ``learning`` (the
    learning-curve summary) and ``drift_baseline`` (the training rows'
    per-feature bin occupancy) are stamped when ``SM_MODEL_TELEMETRY`` was
    on."""
    manifest = {
        "manifest_version": MANIFEST_VERSION,
        "sha256": digest if digest is not None else file_digest(model_path),
        "bytes": int(size) if size is not None else os.path.getsize(model_path),
    }
    if iteration is not None:
        manifest["iteration"] = int(iteration)
    if fingerprint is not None:
        manifest["fingerprint"] = dict(fingerprint)
    if membership_log:
        manifest["membership_log"] = [dict(t) for t in membership_log]
    if quarantine:
        manifest["quarantine"] = dict(quarantine)
    if learning:
        manifest["learning"] = dict(learning)
    if drift_baseline:
        manifest["drift_baseline"] = dict(drift_baseline)
    return manifest


def dump_manifest_atomic(target_path, manifest, tmp_path):
    """Write ``manifest`` as sorted-key JSON to ``tmp_path`` and rename it
    over ``target_path``, removing the temp file on any failure: the one
    serialization of both sidecar writers."""
    try:
        with open(tmp_path, "w") as f:
            json.dump(manifest, f, sort_keys=True)
        os.replace(tmp_path, target_path)
    except BaseException:
        try:
            os.remove(tmp_path)
        except OSError:
            pass
        raise


def write_manifest(model_path, iteration=None, fingerprint=None, quarantine=None,
                   learning=None, drift_baseline=None, membership_log=None):
    """Write ``model_path``'s sidecar manifest (the final model's; the
    checkpoints' go through the checkpoint layer's retried writer).
    ``quarantine``: the streaming ingest's record of the chunks the job
    skipped (``data/streaming.quarantine_record``), None when it skipped
    none; ``membership_log``: the elastic plane's transitions, None when the
    membership never changed. -> the manifest dict."""
    manifest = build_manifest(model_path, iteration=iteration, fingerprint=fingerprint,
                              membership_log=membership_log,
                              quarantine=quarantine, learning=learning,
                              drift_baseline=drift_baseline)
    target = manifest_path(model_path)
    # dot-prefixed temp: the serving loader skips dotfiles, so a crash here
    # never leaves a file that a model-dir scan would try to load
    tmp = os.path.join(os.path.dirname(target) or ".", "." + os.path.basename(target) + ".tmp")
    dump_manifest_atomic(target, manifest, tmp)
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


# -------------------------------------------------------------- fingerprint
def _live_world_size():
    """Hosts of the live job, as the JAX package counts them: the elastic
    membership's world size once it is registered (it follows a shrink),
    else the hosts of this process's local-rank topology (L training
    processes a host are one host, as the JAX one-host mesh is one
    process), else the ranks of the live ``torch.distributed`` group (one a
    host where there is no topology), else 1. A host's workers read the
    same value as their leader."""
    try:
        from ..training import elastic

        world = elastic.world_size()
        if world > 0:
            return int(world)
        from ..parallel import local

        topo = local.topology()
        if topo is not None:
            return topo.num_hosts
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_world_size())
    except Exception:
        pass
    return 1


def config_fingerprint(train_cfg, world_size=None):
    """The live job's config identity, as stored in checkpoint manifests:
    the knobs that change split candidates or the loss (objective,
    tree_method, max_bin, max_depth), the world size (the live job's hosts
    unless given, ``_live_world_size``), and the versions:
    ``jax_version`` (``"absent"``: the port has no jax), ``package_version``
    and the port's ``torch_version``."""
    cfg = dict(train_cfg or {})
    if world_size is None:
        world_size = _live_world_size()
    return {
        "objective": str(cfg.get("objective", "reg:squarederror")),
        "tree_method": str(cfg.get("tree_method", "auto")),
        "max_bin": str(cfg.get("max_bin", "")),
        "max_depth": str(cfg.get("max_depth", "")),
        "world_size": int(world_size),
        "jax_version": "absent",
        "package_version": _package_version(),
        "torch_version": _torch_version(),
    }


def _package_version():
    try:
        from .. import __version__

        return str(__version__)
    except Exception:
        return "unknown"


def _torch_version():
    try:
        import torch

        return str(torch.__version__)
    except Exception:
        return "absent"


def fingerprint_mismatches(expected, actual):
    """[(key, expected, actual), ...] for the keys present in either dict
    (``torch_version`` only where both carry it)."""
    expected, actual = expected or {}, actual or {}
    out = []
    for key in _FINGERPRINT_KEYS:
        present = (key in expected and key in actual) if key == "torch_version" \
            else (key in expected or key in actual)
        if present:
            ev, av = expected.get(key), actual.get(key)
            if str(ev) != str(av):
                out.append((key, ev, av))
    return out


def _world_size_transition_recorded(old, new, membership_log):
    """True when the recorded transitions connect checkpoint world size
    ``old`` to live world size ``new`` in either direction, chains
    included (the JAX package's elastic resume rule)."""
    try:
        old, new = int(old), int(new)
    except (TypeError, ValueError):
        return False
    edges = {}
    for t in membership_log or []:
        try:
            a, b = int(t["old_world_size"]), int(t["new_world_size"])
        except (KeyError, TypeError, ValueError):
            continue
        edges.setdefault(a, set()).add(b)
        edges.setdefault(b, set()).add(a)
    seen, frontier = {old}, [old]
    while frontier:
        for nxt in edges.get(frontier.pop(), ()):
            if nxt not in seen:
                seen.add(nxt)
                frontier.append(nxt)
    return new in seen and new != old


def validate_resume(checkpoint_path, live_fingerprint, membership_log=None):
    """Compare the resume candidate's manifest fingerprint with the live
    job's. A manifest-less checkpoint passes. A mismatch warns naming the
    keys, and under ``SM_RESUME_STRICT=true`` raises UserError. A
    ``world_size``-only drift covered by a recorded membership transition
    (``membership_log``, or the one in the checkpoint's manifest) resumes
    cleanly, as in the JAX package. -> True when nothing differs."""
    if checkpoint_path is None:
        return True
    manifest = read_manifest(checkpoint_path)
    if manifest is None or "fingerprint" not in manifest:
        return True
    diffs = fingerprint_mismatches(manifest["fingerprint"], live_fingerprint)
    if not diffs:
        return True
    ws_diffs = [d for d in diffs if d[0] == "world_size"]
    if ws_diffs and len(ws_diffs) == len(diffs):
        transitions = list(membership_log or []) + list(manifest.get("membership_log") or [])
        _key, ckpt_ws, live_ws = ws_diffs[0]
        if _world_size_transition_recorded(ckpt_ws, live_ws, transitions):
            logger.info("resuming from %s across a recorded membership transition "
                        "(world size %s -> %s)", checkpoint_path, ckpt_ws, live_ws)
            return True
    detail = ", ".join("{}: checkpoint={!r} live={!r}".format(k, ev, av) for k, ev, av in diffs)
    if resume_strict():
        from ..toolkit import exceptions as exc

        raise exc.UserError(
            "Refusing to resume from {}: its config fingerprint disagrees "
            "with the live job ({}). Align the configuration or clear the "
            "checkpoint dir; set {}=false to resume anyway (the remaining "
            "rounds would train under different binning/objective "
            "semantics).".format(checkpoint_path, detail, RESUME_STRICT_ENV)
        )
    logger.warning(
        "resuming from %s despite a config-fingerprint mismatch (%s); the "
        "remaining rounds will train under the LIVE config — set %s=true to "
        "refuse instead", checkpoint_path, detail, RESUME_STRICT_ENV,
    )
    return False


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
