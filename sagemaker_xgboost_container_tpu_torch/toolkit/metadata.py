"""CreateAlgorithm metadata: the TrainingSpecification and
InferenceSpecification documents of an AWS Marketplace listing, built from
the port's validated hyperparameter, channel and metric schemas.

The instance lists come from a static registry: the SageMaker types whose
GPUs the port's kernels are built for (``sm_90a``: the H100 of
``ml.p5.48xlarge``). A caller where the network is reachable may pass a
callable that queries the AWS Pricing API instead; any failure of it falls
back to the registry, so a build without egress still emits a valid spec.
"""

import logging

logger = logging.getLogger(__name__)

DEFAULT_TRAINING_INSTANCES = ["ml.p5.48xlarge"]
DEFAULT_INFERENCE_INSTANCES = list(DEFAULT_TRAINING_INSTANCES)


def training_spec(hyperparameters, channels, metrics, image_uri, supported_instance_types=None,
                  supports_distributed=True):
    return {
        "TrainingImage": image_uri,
        "TrainingChannels": channels.format(),
        "SupportedHyperParameters": hyperparameters.format(),
        "SupportedTrainingInstanceTypes": supported_instance_types
        or DEFAULT_TRAINING_INSTANCES,
        "SupportsDistributedTraining": supports_distributed,
        "MetricDefinitions": metrics.format_definitions(),
        "SupportedTuningJobObjectiveMetrics": metrics.format_tunable(),
    }


def inference_spec(image_uri, supported_content_types, supported_response_types,
                   supported_instance_types=None, supports_realtime=True, supports_batch=True):
    modes = []
    if supports_realtime:
        modes.append("RealTime")
    if supports_batch:
        modes.append("Batch")
    return {
        "Containers": [{"Image": image_uri}],
        "SupportedTransformInstanceTypes": supported_instance_types
        or DEFAULT_INFERENCE_INSTANCES,
        "SupportedRealtimeInferenceInstanceTypes": supported_instance_types
        or DEFAULT_INFERENCE_INSTANCES,
        "SupportedContentTypes": supported_content_types,
        "SupportedResponseMIMETypes": supported_response_types,
        "InferenceSpecificationName": "xgboost-gpu",
        "SupportedInferenceModes": modes,
    }


def fetch_instance_types(fetcher, default):
    """``fetcher()``'s instance types, or ``default`` where there is no
    fetcher, it raises or it returns nothing."""
    if fetcher is None:
        return list(default)
    try:
        fetched = list(fetcher() or [])
    except Exception:  # an optional network query: the registry stands in
        logger.warning("instance-type fetcher failed; using the static registry",
                       exc_info=True)
        return list(default)
    return fetched or list(default)


def generate_algorithm_spec(image_uri, instance_type_fetcher=None):
    """The full CreateAlgorithm document from the live schemas.

    ``instance_type_fetcher``: an optional callable of no arguments that
    returns instance type names; any failure falls back to the registry."""
    from ..algorithm import channels as cv
    from ..algorithm import hyperparameters as hpv
    from ..algorithm import metrics as metrics_mod

    metrics = metrics_mod.initialize()
    hps = hpv.initialize(metrics)
    channels = cv.initialize()
    instances = fetch_instance_types(instance_type_fetcher, DEFAULT_TRAINING_INSTANCES)
    return {
        "TrainingSpecification": training_spec(
            hps, channels, metrics, image_uri, supported_instance_types=instances),
        "InferenceSpecification": inference_spec(
            image_uri,
            supported_instance_types=instances,
            supported_content_types=[
                "text/csv",
                "text/libsvm",
                "application/x-recordio-protobuf",
            ],
            supported_response_types=[
                "text/csv",
                "application/json",
                "application/jsonlines",
                "application/x-recordio-protobuf",
            ],
        ),
    }
