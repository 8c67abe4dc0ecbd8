"""The port's hyperparameter, channel and HPO-metric schemas against the JAX
package's: the same configs give the same validated dict or the same
``UserError`` text in both packages."""

import pytest

from sagemaker_xgboost_container_tpu.algorithm import channels as jax_channels
from sagemaker_xgboost_container_tpu.algorithm import hyperparameters as jax_hpv
from sagemaker_xgboost_container_tpu.algorithm import metrics as jax_metrics
from sagemaker_xgboost_container_tpu.toolkit import exceptions as jax_exc
from sagemaker_xgboost_container_tpu_torch.algorithm import channels, hyperparameters, metrics
from sagemaker_xgboost_container_tpu_torch.toolkit import exceptions as exc

BASE = {"num_round": "10"}

HYPERPARAMETER_CASES = {
    "minimal": {},
    "main_path": {"objective": "binary:logistic", "max_depth": "8", "max_bin": "256",
                  "tree_method": "hist", "eta": "0.2", "eval_metric": "logloss,auc",
                  "early_stopping_rounds": "10", "_tuning_objective_metric": "validation:auc"},
    "aliases": {"learning_rate": "0.1", "min_split_loss": "0.5", "reg_lambda": "2",
                "reg_alpha": "0.1"},
    "every_float": {"gamma": "1.5", "min_child_weight": "3", "max_delta_step": "0.7",
                    "subsample": "0.8", "colsample_bytree": "0.5", "colsample_bylevel": "0.5",
                    "colsample_bynode": "0.5", "scale_pos_weight": "2", "base_score": "0.3",
                    "sketch_eps": "0.05", "tweedie_variance_power": "1.2"},
    "ints": {"csv_weights": "1", "verbosity": "2", "nthread": "4", "seed": "-7",
             "max_leaves": "31", "num_parallel_tree": "2", "refresh_leaf": "0",
             "one_drop": "1", "prob_buffer_row": "2"},
    "categoricals": {"booster": "dart", "sample_type": "weighted", "normalize_type": "forest",
                     "rate_drop": "0.1", "skip_drop": "0.2", "grow_policy": "lossguide",
                     "dsplit": "row", "predictor": "cpu_predictor",
                     "save_model_on_termination": "true", "deterministic_histogram": "false",
                     "sampling_method": "uniform", "use_dask_gpu_training": "false"},
    "multiclass": {"objective": "multi:softprob", "num_class": "3", "eval_metric": "mlogloss"},
    "monotone": {"tree_method": "hist", "monotone_constraints": "(1,0,-1)"},
    "interaction": {"tree_method": "hist", "interaction_constraints": "[[0, 1], [2, 3, 4]]"},
    "updater_tree": {"updater": "grow_histmaker,prune"},
    "updater_linear": {"booster": "gblinear", "updater": "coord_descent", "lambda_bias": "0.5"},
    "process_update": {"process_type": "update", "updater": "refresh"},
    "error_threshold": {"eval_metric": "error@0.7"},
    "ndcg_at": {"objective": "rank:ndcg", "eval_metric": "ndcg@5"},
    "aft": {"objective": "survival:aft", "aft_loss_distribution": "logistic",
            "aft_loss_distribution_scale": "1.5", "eval_metric": "aft-nloglik"},
    "kfold": {"_kfold": "5", "_num_cv_round": "2"},
    "internal": {"_num_devices": "1", "_rounds_per_dispatch": "4"},
    # the objective's dependency check runs only when an objective is given
    "num_class_alone": {"num_class": "3"},
    # rejected from here on
    "missing_num_round": {"num_round": None},
    "num_round_zero": {"num_round": "0"},
    "num_round_not_int": {"num_round": "ten"},
    "eta_too_big": {"eta": "1.5"},
    "negative_gamma": {"gamma": "-1"},
    "subsample_zero": {"subsample": "0"},
    "unknown_key": {"not_a_parameter": "1"},
    "bad_objective": {"objective": "reg:nope"},
    "multiclass_without_num_class": {"objective": "multi:softmax"},
    "gpu_hist": {"tree_method": "gpu_hist"},
    "gpu_predictor": {"predictor": "gpu_predictor"},
    "bad_booster": {"booster": "gbforest"},
    "auc_for_regression": {"objective": "reg:squarederror", "eval_metric": "auc"},
    "aft_metric_wrong_objective": {"objective": "binary:logistic", "eval_metric": "aft-nloglik"},
    "bad_metric_threshold": {"eval_metric": "error@abc"},
    "threshold_on_rmse": {"eval_metric": "rmse@0.5"},
    "unknown_metric": {"eval_metric": "nope"},
    "bad_tuning_metric": {"_tuning_objective_metric": "validation:nope"},
    "monotone_wrong_method": {"tree_method": "approx", "monotone_constraints": "(1,0)"},
    "monotone_bad_value": {"tree_method": "hist", "monotone_constraints": "(2,0)"},
    "interaction_wrong_method": {"tree_method": "auto", "interaction_constraints": "[[0, 1]]"},
    "two_grow_updaters": {"updater": "grow_colmaker,grow_histmaker"},
    "linear_updater_on_trees": {"booster": "gblinear", "updater": "grow_histmaker"},
    "update_with_grow_updater": {"process_type": "update", "updater": "grow_histmaker"},
    "csv_weights_two": {"csv_weights": "2"},
    "tweedie_power_out_of_range": {"tweedie_variance_power": "2.5"},
    "kfold_one": {"_kfold": "1"},
    "seed_too_big": {"seed": str(2 ** 31)},
    "bad_bool": {"save_model_on_termination": "yes"},
}


def _outcome(validate, error_types, config):
    try:
        return "ok", validate(config)
    except error_types as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("case", sorted(HYPERPARAMETER_CASES))
def test_hyperparameters_match_jax(case):
    config = dict(BASE, **HYPERPARAMETER_CASES[case])
    config = {k: v for k, v in config.items() if v is not None}
    ours = hyperparameters.initialize(metrics.initialize())
    ref = jax_hpv.initialize(jax_metrics.initialize())
    a = _outcome(ours.validate, exc.BaseToolkitError, dict(config))
    b = _outcome(ref.validate, jax_exc.BaseToolkitError, dict(config))
    assert a == b
    names = list(HYPERPARAMETER_CASES)
    rejected = case in names[names.index("missing_num_round"):]
    assert a[0] == ("UserError" if rejected else "ok"), a


def test_hyperparameter_schema_format_matches_jax():
    ours = hyperparameters.initialize(metrics.initialize())
    ref = jax_hpv.initialize(jax_metrics.initialize())
    assert ours.format() == ref.format()


FILE = {"TrainingInputMode": "File", "S3DistributionType": "FullyReplicated"}
CHANNEL_CASES = {
    "csv": {"train": dict(FILE, ContentType="csv")},
    "text_csv": {"train": dict(FILE, ContentType="text/csv"),
                 "validation": dict(FILE, ContentType="text/csv")},
    "libsvm_default_content_type": {"train": dict(FILE)},
    "x_libsvm_sharded": {"train": {"ContentType": "text/x-libsvm", "TrainingInputMode": "File",
                                   "S3DistributionType": "ShardedByS3Key"}},
    "parquet": {"train": dict(FILE, ContentType="application/x-parquet")},
    "recordio": {"train": dict(FILE, ContentType="application/x-recordio-protobuf"),
                 "validation": dict(FILE, ContentType="recordio-protobuf")},
    "code_channel": {"train": dict(FILE, ContentType="csv"),
                     "code": {"ContentType": "text/python", "TrainingInputMode": "File",
                              "S3DistributionType": "FullyReplicated"}},
    "missing_train": {"validation": dict(FILE, ContentType="csv")},
    "extraneous": {"train": dict(FILE, ContentType="csv"), "test": dict(FILE, ContentType="csv")},
    "bad_content_type": {"train": dict(FILE, ContentType="application/json")},
    "pipe_mode": {"train": {"ContentType": "csv", "TrainingInputMode": "Pipe",
                            "S3DistributionType": "FullyReplicated"}},
    "augmented_mode": {"train": {"ContentType": "csv", "TrainingInputMode": "Augmented",
                                 "S3DistributionType": "FullyReplicated"}},
    "missing_distribution": {"train": {"ContentType": "csv", "TrainingInputMode": "File"}},
    "bad_distribution": {"train": {"ContentType": "csv", "TrainingInputMode": "File",
                                   "S3DistributionType": "Replicated"}},
}


@pytest.mark.parametrize("case", sorted(CHANNEL_CASES))
def test_channels_match_jax(case):
    config = CHANNEL_CASES[case]
    a = _outcome(channels.initialize().validate, exc.BaseToolkitError, config)
    b = _outcome(jax_channels.initialize().validate, jax_exc.BaseToolkitError, config)
    assert a == b
    ok = case in ("csv", "text_csv", "libsvm_default_content_type", "x_libsvm_sharded",
                  "parquet", "recordio", "code_channel")
    assert (a[0] == "ok") == ok, a


def test_channel_schema_format_matches_jax():
    assert channels.initialize().format() == jax_channels.initialize().format()


def test_metrics_initialize_matches_jax():
    ours, ref = metrics.initialize(), jax_metrics.initialize()
    assert ours.names == ref.names
    assert ours.format_tunable() == ref.format_tunable()
    assert ours.format_definitions() == ref.format_definitions()
    assert "validation:auc" in ours and "validation:logloss" in ours


@pytest.mark.parametrize("error", ["UserError", "AlgorithmError", "PlatformError"])
def test_exceptions_match_jax(error):
    cause = ValueError("bad value")
    a = getattr(exc, error)("message", caused_by=cause)
    b = getattr(jax_exc, error)("message", caused_by=cause)
    assert a.public_failure_message() == b.public_failure_message()
    assert exc.convert_to_algorithm_error(a) is a
    wrapped = exc.convert_to_algorithm_error(KeyError("k"))
    ref = jax_exc.convert_to_algorithm_error(KeyError("k"))
    assert type(wrapped).__name__ == type(ref).__name__ == "AlgorithmError"
    assert wrapped.public_failure_message() == ref.public_failure_message()


# every hyperparameter, at a value that trains the ported slice's model
EVERY_KEY_IN_THE_SLICE = {
    "num_round": "10", "csv_weights": "0", "early_stopping_rounds": "5", "booster": "gbtree",
    "verbosity": "1", "nthread": "4", "eta": "0.2", "gamma": "0.1", "max_depth": "8",
    "min_child_weight": "1", "max_delta_step": "0", "subsample": "1", "colsample_bytree": "1",
    "colsample_bylevel": "1", "colsample_bynode": "1", "lambda": "1", "alpha": "0",
    "tree_method": "hist", "sketch_eps": "0.03", "scale_pos_weight": "1",
    "updater": "grow_quantile_histmaker", "dsplit": "row", "refresh_leaf": "1",
    "process_type": "default", "grow_policy": "depthwise", "max_leaves": "0", "max_bin": "256",
    "predictor": "auto", "sample_type": "uniform", "normalize_type": "tree", "rate_drop": "0",
    "one_drop": "0", "skip_drop": "0", "lambda_bias": "0", "tweedie_variance_power": "1.5",
    "objective": "multi:softprob", "num_class": "3", "base_score": "0.5", "_kfold": "2",
    "_num_cv_round": "1", "_tuning_objective_metric": "validation:merror",
    "eval_metric": "mlogloss,merror", "seed": "3",
    "num_parallel_tree": "1", "save_model_on_termination": "false",
    "aft_loss_distribution": "normal", "aft_loss_distribution_scale": "1",
    "deterministic_histogram": "true", "sampling_method": "uniform", "prob_buffer_row": "2",
    "use_dask_gpu_training": "false", "_num_devices": "1", "_rounds_per_dispatch": "8",
}


def test_train_config_takes_every_validated_key():
    from sagemaker_xgboost_container_tpu_torch.models.booster import TrainConfig

    schema = hyperparameters.initialize(metrics.initialize())
    # the two left out have no value the slice trains: absent is their default
    assert set(schema._schema) - set(EVERY_KEY_IN_THE_SLICE) == {
        "interaction_constraints", "monotone_constraints"}
    assert set(EVERY_KEY_IN_THE_SLICE) <= set(schema._schema)
    validated = schema.validate(dict(EVERY_KEY_IN_THE_SLICE))
    validated["updater"] = ",".join(validated["updater"])
    config = TrainConfig(validated)
    assert (config.max_depth, config.max_bin, config.eta) == (8, 256, 0.2)
    assert (config.objective, config.num_class) == ("multi:softprob", 3)


@pytest.mark.parametrize("key,value", [
    ("objective", "rank:pairwise"), ("objective", "rank:ndcg"), ("booster", "dart"),
    ("booster", "gblinear"), ("tree_method", "exact"), ("tree_method", "approx"),
    ("grow_policy", "lossguide"), ("subsample", "0.5"), ("colsample_bytree", "0.5"),
    ("colsample_bylevel", "0.5"), ("colsample_bynode", "0.5"), ("num_parallel_tree", "2"),
    ("process_type", "update"), ("monotone_constraints", "(1,0)"),
    ("interaction_constraints", "[[0, 1]]"), ("max_depth", "0"),
])
def test_train_config_refuses_what_the_slice_does_not_train(key, value):
    """Refusals, and (since the port trains them) acceptance of the ranking
    objectives, of lossguide with max_leaves, of row and column sampling and
    of num_parallel_tree."""
    from sagemaker_xgboost_container_tpu_torch.models.booster import TrainConfig

    config = {"num_round": "10", "tree_method": "hist", key: value}
    if key == "process_type":
        config["updater"] = "refresh"
    sampling = ("subsample", "colsample_bytree", "colsample_bylevel", "colsample_bynode",
                "num_parallel_tree")
    accepted = value in ("rank:pairwise", "rank:ndcg", "lossguide") or key in sampling
    if value == "lossguide":
        config["max_leaves"] = "31"
    validated = hyperparameters.initialize(metrics.initialize()).validate(config)
    if "updater" in validated:
        validated["updater"] = ",".join(validated["updater"])
    if accepted:
        train_config = TrainConfig(validated)
        assert str(getattr(train_config, key)) == value
        if value == "lossguide":
            assert (train_config.max_leaves, train_config.predict_depth) == (31, 6)
        return
    with pytest.raises(exc.UserError, match=key if key != "max_depth" else "max_depth must be"):
        TrainConfig(validated)
