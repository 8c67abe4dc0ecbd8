"""The names the train and serve paths read: metric lists, customer-error
messages, content types, SageMaker environment variable names, objective
and model names.

These strings are the API through which SageMaker, HPO and customers talk to
the container, so they are the same as the JAX package's
``sagemaker_xgboost_container_tpu/constants.py``.
"""

# metric directions: HPO metric definitions and early stopping's maximize set
XGB_MAXIMIZE_METRICS = [
    "accuracy",
    "auc",
    "aucpr",
    "balanced_accuracy",
    "f1",
    "f1_binary",
    "f1_macro",
    "map",
    "ndcg",
    "precision",
    "r2",
    "recall",
    "precision_macro",
    "precision_micro",
    "recall_macro",
    "recall_micro",
]

XGB_MINIMIZE_METRICS = [
    "aft-nloglik",
    "cox-nloglik",
    "error",
    "gamma-deviance",
    "gamma-nloglik",
    "interval-regression-accuracy",
    "logloss",
    "mae",
    "mape",
    "merror",
    "mlogloss",
    "mphe",
    "mse",
    "poisson-nloglik",
    "rmse",
    "rmsle",
    "tweedie-nloglik",
]

# substrings that classify a training failure as one the customer can fix
LOGISTIC_REGRESSION_LABEL_RANGE_ERROR = "label must be in [0,1] for logistic regression"
MULTI_CLASS_LABEL_RANGE_ERROR = "label must be in [0, num_class)"
MULTI_CLASS_F1_BINARY_ERROR = "Target is multiclass but average='binary'"
FEATURE_MISMATCH_ERROR = "feature_names mismatch"
LABEL_PREDICTION_SIZE_MISMATCH = "Check failed: preds.size() == info.labels_.size()"
ONLY_POS_OR_NEG_SAMPLES = "Check failed: !auc_error AUC: the dataset only contains pos or neg samples"
BASE_SCORE_RANGE_ERROR = (
    "Check failed: base_score > 0.0f && base_score < 1.0f base_score must be in (0,1) "
    "for logistic loss"
)
POISSON_REGRESSION_ERROR = "Check failed: label_correct PoissonRegression: label must be nonnegative"
TWEEDIE_REGRESSION_ERROR = "Check failed: label_correct TweedieRegression: label must be nonnegative"
REG_LAMBDA_ERROR = "Parameter reg_lambda should be greater equal to 0"

CUSTOMER_ERRORS = [
    LOGISTIC_REGRESSION_LABEL_RANGE_ERROR,
    MULTI_CLASS_LABEL_RANGE_ERROR,
    MULTI_CLASS_F1_BINARY_ERROR,
    FEATURE_MISMATCH_ERROR,
    LABEL_PREDICTION_SIZE_MISMATCH,
    ONLY_POS_OR_NEG_SAMPLES,
    BASE_SCORE_RANGE_ERROR,
    POISSON_REGRESSION_ERROR,
    TWEEDIE_REGRESSION_ERROR,
    REG_LAMBDA_ERROR,
]

TRAIN_CHANNEL = "train"
VAL_CHANNEL = "validation"
MODEL_NAME = "xgboost-model"
FULLY_REPLICATED = "FullyReplicated"
PIPE_MODE = "Pipe"

REG_SQUAREDERR = "reg:squarederror"
REG_LOG = "reg:logistic"
REG_GAMMA = "reg:gamma"
REG_ABSOLUTEERR = "reg:absoluteerror"
REG_TWEEDIE = "reg:tweedie"
BINARY_LOG = "binary:logistic"
BINARY_LOGRAW = "binary:logitraw"
BINARY_HINGE = "binary:hinge"
MULTI_SOFTMAX = "multi:softmax"
MULTI_SOFTPROB = "multi:softprob"

# content types
CSV = "text/csv"
LIBSVM = "text/libsvm"
X_LIBSVM = "text/x-libsvm"
PARQUET = "application/x-parquet"
X_PARQUET = "application/x-parquet"
RECORDIO_PROTOBUF = "application/x-recordio-protobuf"
X_RECORDIO_PROTOBUF = "application/x-recordio-protobuf"

# SageMaker environment variable names
SM_CURRENT_HOST = "SM_CURRENT_HOST"
SM_HOSTS = "SM_HOSTS"
SM_CHANNEL_TRAIN = "SM_CHANNEL_TRAIN"
SM_CHANNEL_VALIDATION = "SM_CHANNEL_VALIDATION"
SM_MODEL_DIR = "SM_MODEL_DIR"
SM_INPUT_TRAINING_CONFIG_FILE = "SM_INPUT_TRAINING_CONFIG_FILE"
SM_INPUT_DATA_CONFIG_FILE = "SM_INPUT_DATA_CONFIG_FILE"
SM_CHECKPOINT_CONFIG_FILE = "SM_CHECKPOINT_CONFIG_FILE"
SM_OUTPUT_DATA_DIR = "SM_OUTPUT_DATA_DIR"
SAGEMAKER_INFERENCE_ENSEMBLE = "SAGEMAKER_INFERENCE_ENSEMBLE"
SAGEMAKER_INFERENCE_OUTPUT = "SAGEMAKER_INFERENCE_OUTPUT"
SAGEMAKER_DEFAULT_INVOCATIONS_ACCEPT = "SAGEMAKER_DEFAULT_INVOCATIONS_ACCEPT"
SAGEMAKER_BATCH = "SAGEMAKER_BATCH"

ONE_THREAD_PER_PROCESS = "1"

# supervision exit codes, the JAX package's: distinct non-zero codes above
# the shell and signal ranges, so the platform restarts the job or server and
# its log names which supervisor pulled the trigger
EXIT_ROUND_DEADLINE = 79  # round watchdog: a boosting round exceeded SM_ROUND_DEADLINE_S
EXIT_CLUSTER_ABORT = 80  # coordinated abort: rank 0 declared a peer dead
EXIT_DRAIN_TIMEOUT = 83  # SIGTERM drain: requests still in flight past SM_DRAIN_TIMEOUT_S
EXIT_PREDICT_STUCK = 84  # predict watchdog: a dispatch wedged past SM_PREDICT_STUCK_S (abort)
EXIT_INGEST_FAILED = 85  # streaming ingest: a bad chunk, skip budget or plan divergence
EXIT_DEVICE_OOM = 86  # the device allocator ran out inside a round; forensics dumped
EXIT_NUMERIC_POISON = 87  # learning telemetry: NaN/Inf in gradients or margins; forensics dumped
