"""SageMaker training-channel schema + validation.

The port's copy of ``sagemaker_xgboost_container_tpu/toolkit/channels.py``:
each channel declares the set of supported (content-type, input-mode, S3
distribution) triples; runtime channel configs are checked against that set,
with a schema-level default content type filled in when the platform omits
one.
"""

from . import exceptions as exc

CONTENT_TYPE = "ContentType"
TRAINING_INPUT_MODE = "TrainingInputMode"
S3_DIST_TYPE = "S3DistributionType"

FILE_MODE = "File"
PIPE_MODE = "Pipe"
AUGMENTED_MODE = "Augmented"

SHARDED = "ShardedByS3Key"
REPLICATED = "FullyReplicated"


class Channel:
    """One training channel and its supported configuration matrix."""

    # class-level aliases so schema modules can say Channel.FILE_MODE
    FILE_MODE = FILE_MODE
    PIPE_MODE = PIPE_MODE
    AUGMENTED_MODE = AUGMENTED_MODE
    SHARDED = SHARDED
    REPLICATED = REPLICATED

    def __init__(self, name, required):
        self.name = name
        self.required = required
        self._supported = set()

    def add(self, content_type, input_mode, s3_distribution):
        self._supported.add((content_type, input_mode, s3_distribution))

    def supports(self, content_type, input_mode, s3_distribution):
        return (content_type, input_mode, s3_distribution) in self._supported

    def validate(self, config):
        triple = (
            config.get(CONTENT_TYPE),
            config.get(TRAINING_INPUT_MODE),
            config.get(S3_DIST_TYPE),
        )
        if triple not in self._supported:
            raise exc.UserError(
                "Channel configuration for '{}' channel is not supported: {}".format(
                    self.name, config
                )
            )

    def format(self):
        return {
            "Name": self.name,
            "Description": self.name,
            "IsRequired": self.required,
            "SupportedContentTypes": sorted({t[0] for t in self._supported}),
            "SupportedInputModes": sorted({t[1] for t in self._supported}),
        }


class Channels:
    """The full channel collection for a training job."""

    def __init__(self, *channels):
        self._channels = {c.name: c for c in channels}
        self.default_content_type = None

    def set_default_content_type(self, content_type):
        self.default_content_type = content_type

    def __getitem__(self, name):
        return self._channels[name]

    def validate(self, user_channels):
        for channel in self._channels.values():
            if channel.required and channel.name not in user_channels:
                raise exc.UserError("Missing required channel: {}".format(channel.name))

        validated = {}
        for name, config in user_channels.items():
            channel = self._channels.get(name)
            if channel is None:
                raise exc.UserError("Extraneous channel found: {}".format(name))
            config = dict(config)
            if CONTENT_TYPE not in config:
                if not self.default_content_type:
                    raise exc.UserError("Missing content type for channel: {}".format(name))
                config[CONTENT_TYPE] = self.default_content_type
            channel.validate(config)
            validated[name] = config
        return validated

    def format(self):
        return [c.format() for c in self._channels.values()]
