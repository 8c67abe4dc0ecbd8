"""The full XGBoost hyperparameter schema, declared against the toolkit engine.

The port's copy of ``sagemaker_xgboost_container_tpu/algorithm/hyperparameters.py``:
every hyperparameter validates as in the JAX package, with the same names,
ranges, dependency rules, aliases and messages (some of which name the TPU
container: they are the container's public error texts, kept verbatim).
What the port cannot train yet is refused later, by
``models.booster.TrainConfig``.

Internal (underscore-prefixed) flags: ``_kfold``, ``_num_cv_round``,
``_tuning_objective_metric``, ``_num_devices`` and ``_rounds_per_dispatch``.
"""

from ..constants import XGB_MAXIMIZE_METRICS, XGB_MINIMIZE_METRICS
from ..toolkit import exceptions as exc
from ..toolkit.hyperparameters import (
    CategoricalHyperparameter,
    CommaSeparatedListHyperparameter,
    ContinuousHyperparameter,
    Hyperparameters,
    IntegerHyperparameter,
    Interval,
    NestedListHyperparameter,
    TupleHyperparameter,
    dependencies_validator,
    range_validator,
)

TREE_METHODS = ["auto", "exact", "approx", "hist"]
GPU_TREE_METHOD = "gpu_hist"

OBJECTIVES = [
    "aft_loss_distribution",
    "binary:logistic",
    "binary:logitraw",
    "binary:hinge",
    "count:poisson",
    "multi:softmax",
    "multi:softprob",
    "rank:pairwise",
    "rank:ndcg",
    "rank:map",
    "reg:linear",
    "reg:squarederror",
    "reg:logistic",
    "reg:gamma",
    "reg:pseudohubererror",
    "reg:squaredlogerror",
    "reg:absoluteerror",
    "reg:tweedie",
    "survival:aft",
    "survival:cox",
]

TREE_UPDATERS = [
    "grow_colmaker",
    "distcol",
    "grow_histmaker",
    "grow_skmaker",
    "sync",
    "refresh",
    "prune",
    "grow_quantile_histmaker",
]
TREE_GROW_UPDATERS = ["grow_colmaker", "distcol", "grow_histmaker", "grow_quantile_histmaker"]
LINEAR_UPDATERS = ["shotgun", "coord_descent"]
PROCESS_UPDATE_UPDATERS = ["refresh", "prune"]


def initialize(metrics):
    """Build the Hyperparameters registry. ``metrics`` supplies the legal
    values of ``_tuning_objective_metric`` (HPO objective selection)."""

    @range_validator(TREE_METHODS)
    def tree_method_range(choices, value):
        if value == GPU_TREE_METHOD:
            raise exc.UserError(
                "tree_method 'gpu_hist' is not available in the TPU container: there is no "
                "CUDA device. Use tree_method 'hist' — it runs the XLA histogram tree "
                "builder on TPU."
            )
        return value in choices

    @range_validator(["auto", "cpu_predictor"])
    def predictor_range(choices, value):
        if value == "gpu_predictor":
            raise exc.UserError(
                "predictor 'gpu_predictor' is not available in the TPU container; "
                "prediction always uses the compiled XLA forest kernel. Use 'auto'."
            )
        return value in choices

    @dependencies_validator(["booster", "process_type"])
    def check_updater(value, deps):
        if deps.get("booster") == "gblinear":
            if len(value) != 1 or value[0] not in LINEAR_UPDATERS:
                raise exc.UserError(
                    "Linear updater should be one of these options: {}.".format(
                        ", ".join("'{}'".format(u) for u in LINEAR_UPDATERS)
                    )
                )
            return
        if deps.get("process_type") == "update":
            if not all(u in PROCESS_UPDATE_UPDATERS for u in value):
                raise exc.UserError(
                    "process_type 'update' can only be used with updater 'refresh' and 'prune'"
                )
            return
        if not all(u in TREE_UPDATERS for u in value):
            raise exc.UserError(
                "Tree updater should be selected from these options: {}.".format(
                    ", ".join("'{}'".format(u) for u in TREE_UPDATERS + LINEAR_UPDATERS)
                )
            )
        n_grow = sum(1 for u in value if u in TREE_GROW_UPDATERS)
        if n_grow > 1:
            raise exc.UserError(
                "Only one tree grow plugin can be selected. Choose one from the following: "
                + ", ".join("'{}'".format(u) for u in TREE_GROW_UPDATERS)
            )

    @dependencies_validator(["num_class"])
    def check_objective(value, deps):
        num_class = deps.get("num_class")
        if value in ("multi:softmax", "multi:softprob") and num_class is None:
            raise exc.UserError(
                "Require input for parameter 'num_class' for multi-classification"
            )
        if value is None and num_class is not None:
            raise exc.UserError(
                "Do not need to setup parameter 'num_class' for learning task other than "
                "multi-classification."
            )

    @range_validator(XGB_MAXIMIZE_METRICS + XGB_MINIMIZE_METRICS)
    def eval_metric_range(supported, metric):
        if "<function" in metric:
            raise exc.UserError(
                "User defined evaluation metric {} is not supported yet.".format(metric)
            )
        if "@" in metric:
            base, _, threshold = metric.partition("@")
            base = base.strip()
            if base not in ("error", "ndcg", "map"):
                raise exc.UserError(
                    "Metric '{}' is not supported. Parameter 'eval_metric' with customized "
                    "threshold should be one of these options: 'error', 'ndcg', 'map'.".format(
                        metric
                    )
                )
            try:
                float(threshold.strip())
            except ValueError:
                raise exc.UserError(
                    "Threshold value 't' in '{}@t' expects float input.".format(base)
                )
            return True
        return metric in supported

    @dependencies_validator(["objective"])
    def check_eval_metric(value, deps):
        objective = deps.get("objective", "reg:squarederror")
        if "auc" in value and not any(
            objective.startswith(prefix) for prefix in ("binary:", "rank:")
        ):
            raise exc.UserError(
                "Metric 'auc' can only be applied for classification and ranking problems."
            )
        if "aft-nloglik" in value and objective != "survival:aft":
            raise exc.UserError(
                "Metric 'aft-nloglik' can only be applied for 'survival:aft' objective."
            )

    @dependencies_validator(["tree_method"])
    def check_monotone(value, deps):
        if value is not None and deps.get("tree_method") not in ("exact", "hist"):
            raise exc.UserError(
                "monotone_constraints can be used only when the tree_method parameter is set "
                "to either 'exact' or 'hist'."
            )

    @dependencies_validator(["tree_method"])
    def check_interaction(value, deps):
        if value is not None and deps.get("tree_method") not in ("exact", "hist", "approx"):
            raise exc.UserError(
                "interaction_constraints can be used only when the tree_method parameter is "
                "set to either 'exact', 'hist' or 'approx'."
            )

    hps = Hyperparameters(
        IntegerHyperparameter(
            name="num_round",
            required=True,
            range=Interval(min_closed=1),
            tunable=True,
            tunable_recommended_range=Interval(
                min_closed=1, max_closed=4000, scale=Interval.LINEAR_SCALE
            ),
        ),
        IntegerHyperparameter(
            name="csv_weights", range=Interval(min_closed=0, max_closed=1), required=False
        ),
        IntegerHyperparameter(
            name="early_stopping_rounds", range=Interval(min_closed=1), required=False
        ),
        CategoricalHyperparameter(
            name="booster", range=["gbtree", "gblinear", "dart"], required=False
        ),
        IntegerHyperparameter(
            name="verbosity", range=Interval(min_closed=0, max_closed=3), required=False
        ),
        IntegerHyperparameter(name="nthread", range=Interval(min_closed=1), required=False),
        ContinuousHyperparameter(
            name="eta",
            range=Interval(min_closed=0, max_closed=1),
            required=False,
            tunable=True,
            tunable_recommended_range=Interval(
                min_closed=0.1, max_closed=0.5, scale=Interval.LINEAR_SCALE
            ),
        ),
        ContinuousHyperparameter(
            name="gamma",
            range=Interval(min_closed=0),
            required=False,
            tunable=True,
            tunable_recommended_range=Interval(
                min_closed=0, max_closed=5, scale=Interval.LINEAR_SCALE
            ),
        ),
        IntegerHyperparameter(
            name="max_depth",
            range=Interval(min_closed=0),
            required=False,
            tunable=True,
            tunable_recommended_range=Interval(
                min_closed=0, max_closed=10, scale=Interval.LINEAR_SCALE
            ),
        ),
        ContinuousHyperparameter(
            name="min_child_weight",
            range=Interval(min_closed=0),
            required=False,
            tunable=True,
            tunable_recommended_range=Interval(
                min_closed=0, max_closed=120, scale=Interval.LINEAR_SCALE
            ),
        ),
        ContinuousHyperparameter(
            name="max_delta_step",
            range=Interval(min_closed=0),
            required=False,
            tunable=True,
            tunable_recommended_range=Interval(
                min_closed=0, max_closed=10, scale=Interval.LINEAR_SCALE
            ),
        ),
        ContinuousHyperparameter(
            name="subsample",
            range=Interval(min_open=0, max_closed=1),
            required=False,
            tunable=True,
            tunable_recommended_range=Interval(
                min_closed=0.5, max_closed=1, scale=Interval.LINEAR_SCALE
            ),
        ),
        ContinuousHyperparameter(
            name="colsample_bytree",
            range=Interval(min_open=0, max_closed=1),
            required=False,
            tunable=True,
            tunable_recommended_range=Interval(
                min_closed=0.5, max_closed=1, scale=Interval.LINEAR_SCALE
            ),
        ),
        ContinuousHyperparameter(
            name="colsample_bylevel",
            range=Interval(min_open=0, max_closed=1),
            required=False,
            tunable=True,
            tunable_recommended_range=Interval(
                min_closed=0.1, max_closed=1, scale=Interval.LINEAR_SCALE
            ),
        ),
        ContinuousHyperparameter(
            name="colsample_bynode",
            range=Interval(min_open=0, max_closed=1),
            required=False,
            tunable=True,
            tunable_recommended_range=Interval(
                min_closed=0.1, max_closed=1, scale=Interval.LINEAR_SCALE
            ),
        ),
        ContinuousHyperparameter(
            name="lambda",
            range=Interval(min_closed=0),
            required=False,
            tunable=True,
            tunable_recommended_range=Interval(
                min_closed=0, max_closed=1000, scale=Interval.LINEAR_SCALE
            ),
        ),
        ContinuousHyperparameter(
            name="alpha",
            range=Interval(min_closed=0),
            required=False,
            tunable=True,
            tunable_recommended_range=Interval(
                min_closed=0, max_closed=1000, scale=Interval.LINEAR_SCALE
            ),
        ),
        CategoricalHyperparameter(name="tree_method", range=tree_method_range, required=False),
        ContinuousHyperparameter(
            name="sketch_eps", range=Interval(min_open=0, max_open=1), required=False
        ),
        ContinuousHyperparameter(
            name="scale_pos_weight", range=Interval(min_open=0), required=False
        ),
        CommaSeparatedListHyperparameter(
            name="updater",
            range=TREE_UPDATERS + LINEAR_UPDATERS,
            dependencies=check_updater,
            required=False,
        ),
        CategoricalHyperparameter(name="dsplit", range=["row", "col"], required=False),
        IntegerHyperparameter(
            name="refresh_leaf", range=Interval(min_closed=0, max_closed=1), required=False
        ),
        CategoricalHyperparameter(
            name="process_type", range=["default", "update"], required=False
        ),
        CategoricalHyperparameter(
            name="grow_policy", range=["depthwise", "lossguide"], required=False
        ),
        IntegerHyperparameter(name="max_leaves", range=Interval(min_closed=0), required=False),
        IntegerHyperparameter(name="max_bin", range=Interval(min_closed=0), required=False),
        CategoricalHyperparameter(name="predictor", range=predictor_range, required=False),
        TupleHyperparameter(
            name="monotone_constraints",
            range=[-1, 0, 1],
            required=False,
            dependencies=check_monotone,
        ),
        NestedListHyperparameter(
            name="interaction_constraints",
            range=Interval(min_closed=0),
            required=False,
            dependencies=check_interaction,
        ),
        CategoricalHyperparameter(
            name="sample_type", range=["uniform", "weighted"], required=False
        ),
        CategoricalHyperparameter(
            name="normalize_type", range=["tree", "forest"], required=False
        ),
        ContinuousHyperparameter(
            name="rate_drop", range=Interval(min_closed=0, max_closed=1), required=False
        ),
        IntegerHyperparameter(
            name="one_drop", range=Interval(min_closed=0, max_closed=1), required=False
        ),
        ContinuousHyperparameter(
            name="skip_drop", range=Interval(min_closed=0, max_closed=1), required=False
        ),
        ContinuousHyperparameter(
            name="lambda_bias", range=Interval(min_closed=0, max_closed=1), required=False
        ),
        ContinuousHyperparameter(
            name="tweedie_variance_power",
            range=Interval(min_open=1, max_open=2),
            required=False,
        ),
        CategoricalHyperparameter(
            name="objective", range=OBJECTIVES, dependencies=check_objective, required=False
        ),
        IntegerHyperparameter(name="num_class", range=Interval(min_closed=2), required=False),
        ContinuousHyperparameter(
            name="base_score", range=Interval(min_closed=0), required=False
        ),
        IntegerHyperparameter(
            name="_kfold", range=Interval(min_closed=2), required=False, tunable=False
        ),
        IntegerHyperparameter(
            name="_num_cv_round", range=Interval(min_closed=1), required=False, tunable=False
        ),
        CategoricalHyperparameter(
            name="_tuning_objective_metric", range=metrics.names, required=False
        ),
        CommaSeparatedListHyperparameter(
            name="eval_metric",
            range=eval_metric_range,
            dependencies=check_eval_metric,
            required=False,
        ),
        IntegerHyperparameter(
            name="seed",
            range=Interval(min_open=-(2**31), max_open=2**31 - 1),
            required=False,
        ),
        IntegerHyperparameter(
            name="num_parallel_tree", range=Interval(min_closed=1), required=False
        ),
        CategoricalHyperparameter(
            name="save_model_on_termination", range=["true", "false"], required=False
        ),
        CategoricalHyperparameter(
            name="aft_loss_distribution",
            range=["normal", "logistic", "extreme"],
            required=False,
        ),
        ContinuousHyperparameter(
            name="aft_loss_distribution_scale", range=Interval(min_closed=0), required=False
        ),
        CategoricalHyperparameter(
            name="deterministic_histogram", range=["true", "false"], required=False
        ),
        CategoricalHyperparameter(
            name="sampling_method", range=["uniform", "gradient_based"], required=False
        ),
        IntegerHyperparameter(
            name="prob_buffer_row", range=Interval(min_open=1.0), required=False
        ),
        # Accepted for API compatibility; training refuses "true".
        CategoricalHyperparameter(
            name="use_dask_gpu_training", range=["true", "false"], required=False
        ),
        # Internal: cap the number of devices used for training.
        IntegerHyperparameter(
            name="_num_devices", range=Interval(min_closed=1), required=False, tunable=False
        ),
        # Internal: trees per device dispatch in the JAX package; the port
        # builds one tree a round whatever its value.
        IntegerHyperparameter(
            name="_rounds_per_dispatch",
            range=Interval(min_closed=1),
            required=False,
            tunable=False,
        ),
    )

    hps.declare_alias("eta", "learning_rate")
    hps.declare_alias("gamma", "min_split_loss")
    hps.declare_alias("lambda", "reg_lambda")
    hps.declare_alias("alpha", "reg_alpha")

    return hps
