"""The names the serve path reads: content types, SageMaker environment
variable names and objective names.

These strings are the API through which SageMaker and its customers talk to
the container, so they are the same as the JAX package's
``sagemaker_xgboost_container_tpu/constants.py``.
"""

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
X_PARQUET = "application/x-parquet"
X_RECORDIO_PROTOBUF = "application/x-recordio-protobuf"

# SageMaker environment variable names
SM_MODEL_DIR = "SM_MODEL_DIR"
SAGEMAKER_INFERENCE_ENSEMBLE = "SAGEMAKER_INFERENCE_ENSEMBLE"
SAGEMAKER_INFERENCE_OUTPUT = "SAGEMAKER_INFERENCE_OUTPUT"
SAGEMAKER_DEFAULT_INVOCATIONS_ACCEPT = "SAGEMAKER_DEFAULT_INVOCATIONS_ACCEPT"
SAGEMAKER_BATCH = "SAGEMAKER_BATCH"

ONE_THREAD_PER_PROCESS = "1"
