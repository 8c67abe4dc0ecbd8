"""Carry a model of the JAX package (``sagemaker_xgboost_container_tpu``)
into this package's ``Forest``.

Two input forms, both plain data (this module imports nothing of the JAX
package):

* the JAX ``Forest.save_json()`` document, as a JSON string or the parsed
  dict;
* padded tree arrays as the JAX trainer produces them, as a dict::

      {"trees": [padded tree dicts in the ops/tree_build.unpack_tree layout],
       "cut_points": [per-feature float32 cut arrays],
       "objective": "binary:logistic", "base_score": 0.5,
       "num_feature": d, "objective_params": {...}}   # last three optional

  Each tree is one boosting round of a single-output model.
"""

import json

from .models.forest import Forest, compact_padded_tree


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
        device=device,
    )
    for padded in ref["trees"]:
        forest.append_round([compact_padded_tree(padded, cuts)], [0])
    return forest
