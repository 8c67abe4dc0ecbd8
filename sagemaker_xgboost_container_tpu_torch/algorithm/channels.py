"""Channel schema: train (required) / validation / code.

The port's copy of ``sagemaker_xgboost_container_tpu/algorithm/channels.py``:
CSV, libsvm, parquet and recordio-protobuf in File mode under both S3
distribution types; default content type ``text/libsvm``; Pipe mode is
declared unsupported.
"""

from .. import constants
from ..toolkit.channels import Channel, Channels

# Both the bare short names and the MIME forms validate, matching the
# reference's VALID_CONTENT_TYPES (data_utils.py:38-48).
VALID_CONTENT_TYPES = [
    "csv",
    "libsvm",
    "parquet",
    "recordio-protobuf",
    constants.CSV,
    constants.LIBSVM,
    constants.X_LIBSVM,
    constants.PARQUET,
    constants.RECORDIO_PROTOBUF,
]

# Pipe mode is not supported.
VALID_PIPED_CONTENT_TYPES = []


def initialize():
    def data_channel(name, required):
        ch = Channel(name=name, required=required)
        for ct in VALID_CONTENT_TYPES:
            ch.add(ct, Channel.FILE_MODE, Channel.SHARDED)
            ch.add(ct, Channel.FILE_MODE, Channel.REPLICATED)
        for ct in VALID_PIPED_CONTENT_TYPES:
            ch.add(ct, Channel.PIPE_MODE, Channel.SHARDED)
            ch.add(ct, Channel.PIPE_MODE, Channel.REPLICATED)
        return ch

    code = Channel(name="code", required=False)
    code.add("text/python", Channel.FILE_MODE, Channel.REPLICATED)

    channels = Channels(
        data_channel(constants.TRAIN_CHANNEL, required=True),
        data_channel(constants.VAL_CHANNEL, required=False),
        code,
    )
    channels.set_default_content_type(constants.LIBSVM)
    return channels
