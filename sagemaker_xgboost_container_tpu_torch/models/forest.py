"""Forest: the trained model — host representation + xgboost JSON codec.

The model artifact stays xgboost-compatible: it serializes to the public
xgboost JSON schema, so the ``xgboost-model`` file of the serving contract
keeps its format and models trained elsewhere load into this predictor.

Host side each tree is compact arrays (left/right children, split feature,
float threshold, default_left, values); for inference the forest stacks into
padded [T, N] tensors on the forest's device, consumed by ops.predict. Trees
coming out of the trainer arrive in the padded full-binary layout with *bin*
splits and are compacted here, converting bins to float thresholds via the
binning cuts (bin(v) <= b  <=>  v < cuts[b] by construction).
"""

import json
import threading

import numpy as np
import torch

from .._device import resolve_device
from ..ops.predict import forest_leaf_nodes, forest_predict_margin, host_predict_margin
from ..telemetry import tracing
from ..toolkit import exceptions as exc
from ..utils.envconfig import env_int
from . import objectives as objectives_mod


# GRAFT_HOST_PREDICT_ROWS' default
HOST_PREDICT_ROWS = 32


def _host_predict_rows():
    """Payloads of up to this many rows predict on the host (the native
    traversal, or numpy), where a device round trip costs more than the
    traversal itself: ``GRAFT_HOST_PREDICT_ROWS``, default
    ``HOST_PREDICT_ROWS``; 0 sends every payload to the device."""
    return env_int("GRAFT_HOST_PREDICT_ROWS", HOST_PREDICT_ROWS)


# predict_margin calls by path, for showing where served traffic ran
PREDICTS = {"host": 0, "device": 0}
_PREDICTS_LOCK = threading.Lock()


def reset_predict_counts():
    with _PREDICTS_LOCK:
        for k in PREDICTS:
            PREDICTS[k] = 0


def _count_predict(path):
    with _PREDICTS_LOCK:
        PREDICTS[path] += 1


class Tree:
    """One decision tree, compact arrays, xgboost node ordering (root = 0).

    ``categories``: optional {node id: int array} of partition-based
    categorical splits (xgboost ``enable_categorical``), each the set of
    categories that routes to the RIGHT child (xgboost common::Decision);
    missing values follow ``default_left``, invalid ones go left. The
    trainer never makes them; they come with BYO xgboost models.
    """

    def __init__(self, feature, threshold, default_left, left, right, value,
                 base_weight=None, gain=None, sum_hess=None, parent=None,
                 categories=None):
        self.feature = np.asarray(feature, np.int32)
        self.threshold = np.asarray(threshold, np.float32)
        self.default_left = np.asarray(default_left, np.bool_)
        self.left = np.asarray(left, np.int32)
        self.right = np.asarray(right, np.int32)
        self.value = np.asarray(value, np.float32)  # leaf value at leaves
        n = len(self.feature)
        self.base_weight = np.asarray(
            base_weight if base_weight is not None else np.zeros(n), np.float32
        )
        self.gain = np.asarray(gain if gain is not None else np.zeros(n), np.float32)
        self.sum_hess = np.asarray(sum_hess if sum_hess is not None else np.zeros(n), np.float32)
        self.parent = np.asarray(
            parent if parent is not None else _parents_from_children(self.left, self.right),
            np.int32,
        )
        self.categories = {
            int(k): np.asarray(v, np.int64) for k, v in (categories or {}).items()
        }

    @property
    def num_nodes(self):
        return len(self.feature)

    @property
    def has_categorical(self):
        return bool(self.categories)

    def max_category(self):
        return max((int(v.max()) for v in self.categories.values() if len(v)), default=-1)

    @property
    def is_leaf(self):
        return self.left < 0

    def depth(self):
        """Max root->leaf depth (host-side, for the traversal's round count)."""
        depth = 0
        frontier = [(0, 0)]
        while frontier:
            node, d = frontier.pop()
            depth = max(depth, d)
            if self.left[node] >= 0:
                frontier.append((int(self.left[node]), d + 1))
                frontier.append((int(self.right[node]), d + 1))
        return depth


def _parents_from_children(left, right):
    parent = np.full(len(left), 2147483647, np.int32)  # xgboost root parent marker
    for i, (l, r) in enumerate(zip(left, right)):
        if l >= 0:
            parent[l] = i
            parent[r] = i
    return parent


def compact_padded_tree(padded, cut_points):
    """Trainer's padded arrays (numpy) -> compact Tree.

    Keeps only reachable nodes (BFS from root through explicit child indices);
    split bin indices become float thresholds via the feature's cut array.
    """
    is_leaf = np.asarray(padded["is_leaf"])
    feature = np.asarray(padded["feature"])
    bin_idx = np.asarray(padded["bin"])
    default_left = np.asarray(padded["default_left"])
    leaf_value = np.asarray(padded["leaf_value"])
    base_weight = np.asarray(padded["base_weight"])
    gain = np.asarray(padded["gain"])
    sum_hess = np.asarray(padded["sum_hess"])
    child_left = np.asarray(padded["left"])
    child_right = np.asarray(padded["right"])

    # BFS in padded numbering, assigning compact ids in visit order
    order = [0]
    compact_id = {0: 0}
    for node in order:
        if not is_leaf[node]:
            for child in (int(child_left[node]), int(child_right[node])):
                compact_id[child] = len(order)
                order.append(child)

    k = len(order)
    out = {
        "feature": np.zeros(k, np.int32),
        "threshold": np.zeros(k, np.float32),
        "default_left": np.zeros(k, np.bool_),
        "left": np.full(k, -1, np.int32),
        "right": np.full(k, -1, np.int32),
        "value": np.zeros(k, np.float32),
        "base_weight": np.zeros(k, np.float32),
        "gain": np.zeros(k, np.float32),
        "sum_hess": np.zeros(k, np.float32),
    }
    for node in order:
        cid = compact_id[node]
        out["base_weight"][cid] = base_weight[node]
        out["sum_hess"][cid] = sum_hess[node]
        if is_leaf[node]:
            out["value"][cid] = leaf_value[node]
        else:
            f = int(feature[node])
            out["feature"][cid] = f
            out["threshold"][cid] = cut_points[f][int(bin_idx[node])]
            out["default_left"][cid] = default_left[node]
            out["left"][cid] = compact_id[int(child_left[node])]
            out["right"][cid] = compact_id[int(child_right[node])]
            out["gain"][cid] = gain[node]
    return Tree(**out)


def _parse_base_score(value):
    """xgboost >= 2.x may store base_score as a vector literal '[5E-1]'."""
    if isinstance(value, str):
        value = value.strip()
        if value.startswith("["):
            value = value.strip("[]").split(",")[0]
    return float(value)


class Forest:
    """The model: trees + objective metadata + prediction entry points.

    ``device``: where ``predict`` traverses the trees (CUDA unless given;
    raises when CUDA is asked for and absent). ``to`` moves the forest.
    """

    def __init__(self, objective_name="reg:squarederror", objective_params=None,
                 base_score=0.5, num_feature=0, num_class=0, feature_names=None,
                 device=None):
        self.trees = []
        self.tree_info = []  # class id per tree (0 for single-output)
        self.iteration_indptr = [0]
        self.objective_name = objective_name
        self.objective_params = dict(objective_params or {})
        self.base_score = float(base_score)
        self.num_feature = int(num_feature)
        self.num_class = int(num_class)  # 0 = not multiclass (xgboost convention)
        self.feature_names = feature_names
        self.attributes = {}
        self.device = resolve_device(device)
        self._stacked = {}
        # serving threads predict concurrently: one of them builds and
        # uploads each tree slice, the others wait for it
        self._stack_lock = threading.Lock()

    def to(self, device):
        """Predict on ``device`` from now on; returns self."""
        with self._stack_lock:
            self.device = resolve_device(device)
            self._stacked = {}
        return self

    def release(self):
        """Drop the trees' copies on the device (a model leaving an
        endpoint); a later predict uploads them again."""
        with self._stack_lock:
            self._stacked = {}

    # ------------------------------------------------------------------ meta
    @property
    def num_output_group(self):
        return max(1, self.num_class)

    @property
    def num_boosted_rounds(self):
        return len(self.iteration_indptr) - 1

    def objective(self):
        params = dict(self.objective_params)
        if self.num_class:
            params.setdefault("num_class", self.num_class)
        return objectives_mod.create_objective(self.objective_name, params)

    # ------------------------------------------------------------- mutation
    def append_round(self, trees, tree_info):
        """Add one boosting round's trees (list[Tree], list[int] class ids)."""
        self.trees.extend(trees)
        self.tree_info.extend(int(c) for c in tree_info)
        self.iteration_indptr.append(len(self.trees))
        with self._stack_lock:
            self._stacked = {}

    # ------------------------------------------------------------ prediction
    def _stack(self, tree_lo=0, tree_hi=None):
        """(host, device): the padded [T, N] numpy arrays of the trees
        ``tree_lo:tree_hi`` (all by default) and their copy on the forest's
        device, memoized per slice until the trees or the device change
        (serving predicts per request). Both halves carry ``cat_split`` and
        ``cat_mask`` when a tree of the slice has categorical splits."""
        key = (tree_lo, len(self.trees) if tree_hi is None else tree_hi)
        with self._stack_lock:
            if key not in self._stacked:
                host = self._stack_uncached(self.trees[key[0]:key[1]])
                dev = None
                if host is not None:
                    dev = {
                        k: v if k == "depth" else torch.as_tensor(v, device=self.device)
                        for k, v in host.items()
                    }
                self._stacked[key] = (host, dev)
            return self._stacked[key]

    def _stack_uncached(self, trees):
        if not trees:
            return None
        N = max(t.num_nodes for t in trees)
        T = len(trees)

        def pad(getter, dtype, fill=0):
            out = np.full((T, N), fill, dtype)
            for i, t in enumerate(trees):
                out[i, : t.num_nodes] = getter(t)
            return out

        self_idx = np.arange(N, dtype=np.int32)[None, :].repeat(T, axis=0)
        left = pad(lambda t: t.left, np.int32, -1)
        right = pad(lambda t: t.right, np.int32, -1)
        is_leaf = left < 0
        stacked = {
            "feature": pad(lambda t: t.feature, np.int32),
            "threshold": pad(lambda t: t.threshold, np.float32),
            "default_left": pad(lambda t: t.default_left, np.bool_),
            "left": np.where(is_leaf, self_idx, left),
            "right": np.where(is_leaf, self_idx, right),
            "is_leaf": is_leaf,
            "leaf_value": pad(lambda t: t.value, np.float32),
            "depth": max(t.depth() for t in trees),
        }
        max_cat = max((t.max_category() for t in trees), default=-1)
        if max_cat >= 0:
            # each node's right-branch categories as a dense bitmask
            # [T, N, W] of xgboost's u32 words, held as int32 (the same bits:
            # torch has few uint32 kernels)
            W = (max_cat >> 5) + 1
            cat_split = np.zeros((T, N), np.bool_)
            cat_mask = np.zeros((T, N, W), np.uint32)
            for i, t in enumerate(trees):
                for node, cats in t.categories.items():
                    cat_split[i, node] = True
                    np.bitwise_or.at(cat_mask[i, node], cats >> 5,
                                     np.left_shift(np.uint32(1), (cats & 31).astype(np.uint32)))
            stacked["cat_split"] = cat_split
            stacked["cat_mask"] = cat_mask.view(np.int32)
        return stacked

    def predict_margin(self, features, iteration_range=None):
        """features: [n, d] float32 (numpy or tensor) with NaN missing ->
        numpy margins, [n] or, for a multi-output model, [n, num_class]
        with each tree's output in the column of its class (``tree_info``).
        ``iteration_range`` (lo, hi) keeps the trees of rounds lo..hi-1
        (hi 0 or None: to the last round)."""
        base = self.objective().base_margin(self.base_score)
        groups = self.num_output_group
        if iteration_range is None:
            lo, hi = 0, self.num_boosted_rounds
        else:
            lo, hi = iteration_range
            hi = hi or self.num_boosted_rounds
        if features.shape[1] < self.num_feature:
            raise exc.UserError(
                "feature_names mismatch: model expects {} features, data has {}".format(
                    self.num_feature, features.shape[1]
                )
            )
        tree_lo, tree_hi = self.iteration_indptr[lo], self.iteration_indptr[hi]
        host, dev = self._stack(tree_lo, tree_hi)
        n = features.shape[0]
        if host is None:
            return np.full(n if groups == 1 else (n, groups), base, np.float32)
        tree_info = self.tree_info[tree_lo:tree_hi]
        if 0 < n <= _host_predict_rows():
            _count_predict("host")
            if isinstance(features, torch.Tensor):
                features = features.cpu().numpy()
            return host_predict_margin(
                host, np.ascontiguousarray(features, np.float32),
                num_output_group=groups, base_margin=base, tree_info=tree_info,
            )
        _count_predict("device")
        x = torch.as_tensor(features, dtype=torch.float32, device=self.device)
        margin = forest_predict_margin(
            dev, x, num_output_group=groups, base_margin=base, tree_info=tree_info)
        tracing.device_sync(self.device)  # SM_TRACE_DEVICE_SYNC's fence
        return margin.cpu().numpy()

    def predict(self, features, output_margin=False, iteration_range=None, pred_leaf=False):
        if pred_leaf:
            return self.predict_leaf(features, iteration_range=iteration_range)
        margin = self.predict_margin(features, iteration_range=iteration_range)
        if output_margin:
            return margin
        return self.objective().margin_to_prediction(margin)

    def predict_leaf(self, features, iteration_range=None):
        """Leaf node id per (row, tree), int32 [n, T] in xgboost's node
        numbering (xgboost ``predict(pred_leaf=True)``), traversed on the
        forest's device."""
        if iteration_range is None:
            lo, hi = 0, self.num_boosted_rounds
        else:
            lo, hi = iteration_range
            hi = hi or self.num_boosted_rounds
        _host, dev = self._stack(self.iteration_indptr[lo], self.iteration_indptr[hi])
        if dev is None:
            return np.zeros((features.shape[0], 0), np.int32)
        x = torch.as_tensor(features, dtype=torch.float32, device=self.device)
        return forest_leaf_nodes(dev, x).to(torch.int32).cpu().numpy()

    # ------------------------------------------------------------ attributes
    def attr(self, key):
        """xgboost Booster.attr: stored attribute or None."""
        return self.attributes.get(key)

    def set_attr(self, **kwargs):
        """xgboost Booster.set_attr: set (or delete with None) attributes."""
        for key, value in kwargs.items():
            if value is None:
                self.attributes.pop(key, None)
            else:
                self.attributes[key] = str(value)

    # ------------------------------------------------------------ importance
    def _feature_name(self, f):
        if self.feature_names and f < len(self.feature_names):
            return self.feature_names[f]
        return "f{}".format(f)

    def get_score(self, importance_type="weight"):
        """Feature importances (xgboost Booster.get_score): weight counts
        splits; total_gain / total_cover sum the loss change / hessian at
        the splits, gain / cover average them. Keys are the feature names
        when known, else ``f<index>``."""
        valid = ("weight", "gain", "cover", "total_gain", "total_cover")
        if importance_type not in valid:
            raise exc.UserError("importance_type must be one of {}".format(", ".join(valid)))
        counts, gains, covers = {}, {}, {}
        for tree in self.trees:
            split = ~tree.is_leaf
            for f, g, c in zip(tree.feature[split], tree.gain[split], tree.sum_hess[split]):
                f = int(f)
                counts[f] = counts.get(f, 0) + 1
                gains[f] = gains.get(f, 0.0) + float(g)
                covers[f] = covers.get(f, 0.0) + float(c)
        name = self._feature_name
        if importance_type == "weight":
            return {name(f): v for f, v in counts.items()}
        if importance_type == "total_gain":
            return {name(f): v for f, v in gains.items()}
        if importance_type == "total_cover":
            return {name(f): v for f, v in covers.items()}
        if importance_type == "gain":
            return {name(f): gains[f] / counts[f] for f in counts}
        return {name(f): covers[f] / counts[f] for f in counts}

    def get_fscore(self):
        return self.get_score("weight")

    def get_dump(self, with_stats=False):
        """Text dump of every tree (xgboost ``Booster.get_dump`` format): a
        line a node in id order, indented by depth; a categorical node
        prints its right-branch set with yes/no swapped (in the set goes
        right)."""
        name = self._feature_name
        dumps = []
        for tree in self.trees:
            lines = {}
            frontier = [(0, 0)]
            while frontier:
                node, depth = frontier.pop()
                indent = "\t" * depth
                if tree.is_leaf[node]:
                    line = "{}{}:leaf={:.9g}".format(indent, node, float(tree.value[node]))
                    if with_stats:
                        line += ",cover={:.9g}".format(float(tree.sum_hess[node]))
                    lines[node] = line
                    continue
                left, right = int(tree.left[node]), int(tree.right[node])
                missing = left if tree.default_left[node] else right
                if node in tree.categories:
                    cond = "{}:{{{}}}".format(name(int(tree.feature[node])), ",".join(
                        str(int(c)) for c in tree.categories[node]))
                    yes, no = right, left
                else:
                    cond = "{}<{:.9g}".format(name(int(tree.feature[node])),
                                              float(tree.threshold[node]))
                    yes, no = left, right
                line = "{}{}:[{}] yes={},no={},missing={}".format(
                    indent, node, cond, yes, no, missing)
                if with_stats:
                    line += ",gain={:.9g},cover={:.9g}".format(
                        float(tree.gain[node]), float(tree.sum_hess[node]))
                lines[node] = line
                frontier.extend([(right, depth + 1), (left, depth + 1)])
            dumps.append("\n".join(lines[k] for k in sorted(lines)) + "\n")
        return dumps

    # ----------------------------------------------------------------- json
    _OBJECTIVE_PARAM_BLOCKS = {
        "reg:squarederror": ("reg_loss_param", {"scale_pos_weight": "1"}),
        "reg:squaredlogerror": ("reg_loss_param", {"scale_pos_weight": "1"}),
        "reg:logistic": ("reg_loss_param", {"scale_pos_weight": "1"}),
        "binary:logistic": ("reg_loss_param", {"scale_pos_weight": "1"}),
        "binary:logitraw": ("reg_loss_param", {"scale_pos_weight": "1"}),
        "count:poisson": ("poisson_regression_param", {"max_delta_step": "0.7"}),
        "reg:tweedie": ("tweedie_regression_param", {"tweedie_variance_power": "1.5"}),
        "reg:pseudohubererror": ("pseudo_huber_param", {"huber_slope": "1"}),
        "multi:softmax": ("softmax_multiclass_param", {"num_class": "0"}),
        "multi:softprob": ("softmax_multiclass_param", {"num_class": "0"}),
        "rank:pairwise": ("lambdarank_param", {}),
        "rank:ndcg": ("lambdarank_param", {}),
        "rank:map": ("lambdarank_param", {}),
    }

    def _tree_to_json(self, tree, tree_id):
        is_leaf = tree.is_leaf
        # xgboost: split_conditions holds the threshold for splits, the leaf
        # value for leaves; split_indices is 0 at leaves.
        split_conditions = np.where(is_leaf, tree.value, tree.threshold)
        # every categorical node's right-branch set in one flat list, with
        # per-node segments (xgboost's layout); split_type 1 marks the node
        cats, cat_nodes, cat_segs, cat_sizes = [], [], [], []
        split_type = [0] * tree.num_nodes
        for node in sorted(tree.categories):
            cat_nodes.append(int(node))
            cat_segs.append(len(cats))
            cat_sizes.append(len(tree.categories[node]))
            cats.extend(int(c) for c in tree.categories[node])
            split_type[node] = 1
        return {
            "base_weights": [float(v) for v in tree.base_weight],
            "categories": cats,
            "categories_nodes": cat_nodes,
            "categories_segments": cat_segs,
            "categories_sizes": cat_sizes,
            "default_left": [int(b) for b in tree.default_left],
            "id": tree_id,
            "left_children": [int(v) for v in tree.left],
            "right_children": [int(v) for v in tree.right],
            "loss_changes": [float(v) for v in tree.gain],
            "parents": [int(v) for v in tree.parent],
            "split_conditions": [float(v) for v in split_conditions],
            "split_indices": [int(v) for v in tree.feature],
            "split_type": split_type,
            "sum_hessian": [float(v) for v in tree.sum_hess],
            "tree_param": {
                "num_deleted": "0",
                "num_feature": str(self.num_feature),
                "num_nodes": str(tree.num_nodes),
                "size_leaf_vector": "1",
            },
        }

    @staticmethod
    def _tree_from_json(blob):
        categories = None
        if blob.get("categories_nodes"):
            flat = np.asarray(blob.get("categories", []), np.int64)
            segs = blob.get("categories_segments", [])
            sizes = blob.get("categories_sizes", [])
            categories = {
                int(node): flat[int(segs[j]):int(segs[j]) + int(sizes[j])]
                for j, node in enumerate(blob["categories_nodes"])
            }
        left = np.asarray(blob["left_children"], np.int32)
        is_leaf = left < 0
        cond = np.asarray(blob["split_conditions"], np.float32)
        return Tree(
            feature=blob["split_indices"],
            threshold=np.where(is_leaf, 0.0, cond),
            default_left=np.asarray(blob["default_left"], bool),
            left=left,
            right=blob["right_children"],
            value=np.where(is_leaf, cond, 0.0),
            base_weight=blob.get("base_weights"),
            gain=blob.get("loss_changes"),
            sum_hess=blob.get("sum_hessian"),
            parent=blob.get("parents"),
            categories=categories,
        )

    def save_json(self):
        block_name, defaults = self._OBJECTIVE_PARAM_BLOCKS.get(
            self.objective_name, ("reg_loss_param", {"scale_pos_weight": "1"})
        )
        block = dict(defaults)
        for key in list(block):
            if key in self.objective_params:
                block[key] = str(self.objective_params[key])
        if "num_class" in block:
            block["num_class"] = str(self.num_class)
        doc = {
            "version": [3, 0, 0],
            "learner": {
                "attributes": self.attributes,
                "feature_names": self.feature_names or [],
                "feature_types": [],
                "gradient_booster": {
                    "model": {
                        "gbtree_model_param": {
                            "num_trees": str(len(self.trees)),
                            "num_parallel_tree": "1",
                        },
                        "iteration_indptr": list(self.iteration_indptr),
                        "tree_info": list(self.tree_info),
                        "trees": [
                            self._tree_to_json(t, i) for i, t in enumerate(self.trees)
                        ],
                    },
                    "name": "gbtree",
                },
                "learner_model_param": {
                    "base_score": repr(self.base_score),
                    "boost_from_average": "1",
                    "num_class": str(self.num_class),
                    "num_feature": str(self.num_feature),
                    "num_target": "1",
                },
                "objective": {"name": self.objective_name, block_name: block},
            },
        }
        return json.dumps(doc)

    @classmethod
    def load_json(cls, text, device=None):
        try:
            doc = json.loads(text)
        except (ValueError, TypeError) as e:
            raise exc.UserError("Not a valid xgboost JSON model", caused_by=e)
        return cls.from_dict(doc, device=device)

    @classmethod
    def from_dict(cls, doc, device=None):
        try:
            learner = doc["learner"]
            gb = learner["gradient_booster"]
            weight_drop = None
            if gb.get("name") == "dart" or "gbtree" in gb:
                # dart nests the tree model under "gbtree" and keeps each
                # tree's dropout scale in "weight_drop"
                weight_drop = gb.get("weight_drop")
                gb = gb["gbtree"]
            if gb.get("name", "gbtree") != "gbtree":
                raise exc.UserError(
                    "{} is not a tree model; load it with "
                    "compat.load_model_any_format".format(gb.get("name")))
            model = gb["model"]
            lmp = learner["learner_model_param"]
            objective = learner["objective"]
        except (KeyError, ValueError, TypeError) as e:
            raise exc.UserError("Not a valid gbtree xgboost JSON model", caused_by=e)
        params = {}
        for block in objective.values():
            if isinstance(block, dict):
                params.update(block)
        forest = cls(
            objective_name=objective["name"],
            objective_params=params,
            base_score=_parse_base_score(lmp.get("base_score", 0.5)),
            num_feature=int(lmp.get("num_feature", 0)),
            num_class=int(lmp.get("num_class", 0)),
            feature_names=learner.get("feature_names") or None,
            device=device,
        )
        forest.attributes = learner.get("attributes", {})
        forest.trees = [cls._tree_from_json(t) for t in model["trees"]]
        if weight_drop:
            for tree, scale in zip(forest.trees, weight_drop):
                tree.value = tree.value * np.float32(scale)
        forest.tree_info = [int(v) for v in model.get("tree_info", [0] * len(forest.trees))]
        indptr = model.get("iteration_indptr")
        if indptr:
            forest.iteration_indptr = [int(v) for v in indptr]
        else:
            forest.iteration_indptr = list(
                range(0, len(forest.trees) + 1, forest.num_output_group)
            )
        return forest

    def save_model(self, path, model_format=None):
        """Write the model as xgboost JSON, or as UBJSON when
        ``model_format`` is "ubj" or, without one, the path ends in .ubj
        (xgboost's choice by extension)."""
        if model_format is None:
            model_format = "ubj" if str(path).endswith(".ubj") else "json"
        if model_format == "ubj":
            from .compat import encode_ubjson  # compat imports this module

            with open(path, "wb") as f:
                f.write(encode_ubjson(json.loads(self.save_json())))
            return
        with open(path, "w") as f:
            f.write(self.save_json())

    @classmethod
    def load_model(cls, path, device=None):
        with open(path, "rb") as f:
            raw = f.read()
        return cls.load_json(raw.decode("utf-8"), device=device)
