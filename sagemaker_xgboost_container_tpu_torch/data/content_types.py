"""Content-type parsing and aliasing.

``get_content_type`` canonicalizes any accepted alias or MIME form to one of
the four short names, honors the csv ``label_size`` parameter, and raises a
UserError listing every accepted type otherwise.
"""

from .. import constants
from ..toolkit import exceptions as exc

CSV = "csv"
LIBSVM = "libsvm"
PARQUET = "parquet"
RECORDIO_PROTOBUF = "recordio-protobuf"

VALID_CONTENT_TYPES = [
    CSV,
    LIBSVM,
    PARQUET,
    RECORDIO_PROTOBUF,
    constants.CSV,
    constants.LIBSVM,
    constants.X_LIBSVM,
    constants.X_PARQUET,
    constants.X_RECORDIO_PROTOBUF,
]

_CSV_ALIASES = {CSV, constants.CSV}
_LIBSVM_ALIASES = {LIBSVM, constants.LIBSVM, constants.X_LIBSVM}
_PARQUET_ALIASES = {PARQUET, constants.X_PARQUET}
_RECORDIO_ALIASES = {RECORDIO_PROTOBUF, constants.X_RECORDIO_PROTOBUF}


def _parse_media_type(value):
    """``"text/csv; label_size=1; charset=utf8"`` -> ("text/csv", {...})."""
    parts = value.split(";")
    media = parts[0].strip()
    params = {}
    for chunk in parts[1:]:
        key, sep, val = chunk.partition("=")
        if sep:
            params[key.strip()] = val.strip().strip('"')
    return media, params


def get_content_type(content_type_cfg_val):
    """Canonicalize a ContentType value; default is libsvm."""
    if content_type_cfg_val is None:
        return LIBSVM
    media, params = _parse_media_type(str(content_type_cfg_val).lower())
    if media in _CSV_ALIASES:
        if params.get("label_size") not in (None, "1"):
            raise exc.UserError(
                "{} is not an accepted csv ContentType. "
                "Optional parameter label_size must be equal to 1".format(content_type_cfg_val)
            )
        return CSV
    if media in _LIBSVM_ALIASES:
        return LIBSVM
    if media in _PARQUET_ALIASES:
        return PARQUET
    if media in _RECORDIO_ALIASES:
        return RECORDIO_PROTOBUF
    raise exc.UserError(
        "{} is not an accepted ContentType: {}.".format(
            content_type_cfg_val, ", ".join(VALID_CONTENT_TYPES)
        )
    )
