"""HPO metric definitions for every supported eval metric.

The regex is the contract: SageMaker HPO scrapes stdout with
``.*\\[[0-9]+\\].*#011validation-<name>:(\\S+)``. The evaluation monitor
prints exactly that line shape (``[<iter>]<tab>train-<m>:<v><tab>validation-<m>:<v>``,
where <tab> renders as ``#011`` in CloudWatch).
"""

from ..constants import XGB_MAXIMIZE_METRICS, XGB_MINIMIZE_METRICS
from ..toolkit.metrics import Metric, Metrics

_REGEX_TEMPLATE = ".*\\[[0-9]+\\].*#011validation-{}:(\\S+)"


def initialize():
    defs = []
    for name in XGB_MAXIMIZE_METRICS:
        defs.append(
            Metric(
                name="validation:{}".format(name),
                direction=Metric.MAXIMIZE,
                regex=_REGEX_TEMPLATE.format(name),
            )
        )
    for name in XGB_MINIMIZE_METRICS:
        defs.append(
            Metric(
                name="validation:{}".format(name),
                direction=Metric.MINIMIZE,
                regex=_REGEX_TEMPLATE.format(name),
            )
        )
    return Metrics(*defs)
