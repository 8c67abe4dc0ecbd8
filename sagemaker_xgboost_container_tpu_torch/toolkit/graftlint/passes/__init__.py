"""graftlint's passes. The order is the report's only; every selected pass
runs."""

from .capture import CaptureSafetyPass
from .concurrency import ConcurrencyPass
from .contract import ContractDriftPass
from .legacy import LegacyGatesPass

ALL_PASSES = [
    CaptureSafetyPass,
    ConcurrencyPass,
    ContractDriftPass,
    LegacyGatesPass,
]
