"""HPO metric definitions: the stdout-regex contract.

The port's copy of ``sagemaker_xgboost_container_tpu/toolkit/metrics.py``.
SageMaker HPO and CloudWatch observe training only through regexes applied
to stdout: each metric carries the scrape regex and an optimization
direction, and the evaluation monitor must print lines those regexes match.
"""

from . import exceptions as exc

MAXIMIZE = "Maximize"
MINIMIZE = "Minimize"


class Metric:
    MAXIMIZE = MAXIMIZE
    MINIMIZE = MINIMIZE

    def __init__(self, name, regex, direction=None, tunable=True, format_string=None):
        if tunable and direction is None:
            raise exc.AlgorithmError("Tunable metric {} needs a direction".format(name))
        self.name = name
        self.regex = regex
        self.direction = direction
        self.tunable = tunable
        self.format_string = format_string

    def format_tunable(self):
        return {"MetricName": self.name, "Type": self.direction}

    def format_definition(self):
        return {"Name": self.name, "Regex": self.regex}


class Metrics:
    def __init__(self, *metrics):
        self._metrics = {m.name: m for m in metrics}

    def __getitem__(self, name):
        return self._metrics[name]

    def __contains__(self, name):
        return name in self._metrics

    @property
    def names(self):
        return list(self._metrics)

    def format_tunable(self):
        return [m.format_tunable() for m in self._metrics.values() if m.tunable]

    def format_definitions(self):
        return [m.format_definition() for m in self._metrics.values()]
