"""Carry a model of the JAX package (``sagemaker_xgboost_container_tpu``)
into this package's ``Forest`` (gbtree and dart) or ``LinearModel``
(gblinear, ``linear_from_reference``).

Two input forms, both plain data (this module imports nothing of the JAX
package):

* the JAX ``Forest.save_json()`` document, as a JSON string or the parsed
  dict;
* padded tree arrays as the JAX trainer produces them, as a dict::

      {"trees": [padded tree dicts in the ops/tree_build.unpack_tree layout],
       "cut_points": [per-feature float32 cut arrays],
       "objective": "binary:logistic", "base_score": 0.5,
       "num_feature": d, "objective_params": {...},
       "num_class": C}   # last four optional

  Each entry of "trees" is one boosting round: a tree of a single-output
  model (arrays [max_nodes]), or the C trees of a multiclass round as the
  JAX trainer's class-vmapped builder packs them (arrays [C, max_nodes]),
  committed with ``tree_info`` 0..C-1.
"""

import json

import numpy as np

from .models.forest import Forest, compact_padded_tree
from .models.gblinear import LinearModel


def forest_from_reference(doc_or_arrays, device=None):
    """-> Forest on ``device`` (CUDA unless given)."""
    ref = doc_or_arrays
    if isinstance(ref, (str, bytes)):
        ref = json.loads(ref)
    if "learner" in ref:
        return Forest.from_dict(ref, device=device)
    cuts = ref["cut_points"]
    forest = Forest(
        objective_name=ref.get("objective", "reg:squarederror"),
        objective_params=ref.get("objective_params"),
        base_score=ref.get("base_score", 0.5),
        num_feature=ref.get("num_feature", len(cuts)),
        num_class=ref.get("num_class", 0),
        device=device,
    )
    for padded in ref["trees"]:
        arrays = {k: np.asarray(v) for k, v in padded.items()}
        if arrays["feature"].ndim == 1:
            forest.append_round([compact_padded_tree(arrays, cuts)], [0])
            continue
        classes = arrays["feature"].shape[0]
        forest.append_round(
            [compact_padded_tree({k: v[c] for k, v in arrays.items()}, cuts)
             for c in range(classes)],
            list(range(classes)),
        )
    return forest


def linear_from_reference(doc, device=None):
    """The JAX ``LinearModel.save_json()`` document (a JSON string or the
    parsed dict) -> LinearModel on ``device`` (CUDA unless given)."""
    if isinstance(doc, (str, bytes)):
        doc = json.loads(doc)
    return LinearModel.from_dict(doc, device=device)
