"""Declarative hyperparameter schema + validation engine.

The port's copy of ``sagemaker_xgboost_container_tpu/toolkit/hyperparameters.py``
(pure Python, kept identical so that both packages accept and reject the
same hyperparameters with the same messages). The contract:

* Every SageMaker hyperparameter arrives as a *string*; the schema declares the
  type, range, default, tunability, aliases and cross-parameter dependencies.
* ``Hyperparameters.validate`` runs four phases:
    1. required check / default fill,
    2. string -> typed parse,
    3. per-value range validation,
    4. dependency validation in topological order over the dependency graph.
* Errors are classified: anything the customer can fix raises ``UserError``;
  schema bugs raise ``AlgorithmError``.
* ``format()`` emits the SageMaker CreateAlgorithm hyperparameter specification.
"""

import ast
import sys

from . import exceptions as exc

_INT32_MIN = -(2**31)
_INT32_MAX = 2**31 - 1


class Interval:
    """Numeric interval with independently open/closed endpoints.

    Unset endpoints are unbounded. Mirrors the semantics of the reference
    Interval (hyperparameter_validation.py:332-389) including the string
    rendering used in UserError messages.
    """

    LINEAR_SCALE = "Linear"
    LOG_SCALE = "Logarithmic"

    def __init__(self, min_open=None, min_closed=None, max_open=None, max_closed=None, scale=None):
        if min_open is not None and min_closed is not None:
            raise exc.AlgorithmError("Interval: specify at most one lower bound")
        if max_open is not None and max_closed is not None:
            raise exc.AlgorithmError("Interval: specify at most one upper bound")
        self.min_open = min_open
        self.min_closed = min_closed
        self.max_open = max_open
        self.max_closed = max_closed
        self.scale = scale

    def __contains__(self, value):
        if self.min_open is not None and not value > self.min_open:
            return False
        if self.min_closed is not None and not value >= self.min_closed:
            return False
        if self.max_open is not None and not value < self.max_open:
            return False
        if self.max_closed is not None and not value <= self.max_closed:
            return False
        return True

    def __str__(self):
        if self.min_open is not None:
            lo = "({}".format(self.min_open)
        elif self.min_closed is not None:
            lo = "[{}".format(self.min_closed)
        else:
            lo = "(-inf"
        if self.max_open is not None:
            hi = "{})".format(self.max_open)
        elif self.max_closed is not None:
            hi = "{}]".format(self.max_closed)
        else:
            hi = "+inf)"
        return "{}, {}".format(lo, hi)

    def _bounds(self, lo_default, hi_default):
        lo = self.min_open if self.min_open is not None else self.min_closed
        hi = self.max_open if self.max_open is not None else self.max_closed
        return (
            str(lo if lo is not None else lo_default),
            str(hi if hi is not None else hi_default),
        )

    def format_as_integer(self):
        return self._bounds(_INT32_MIN, _INT32_MAX)

    def format_as_continuous(self):
        return self._bounds(-sys.float_info.max, sys.float_info.max)


class CustomRange:
    """A range whose membership test is a user-supplied predicate.

    Produced by the :func:`range_validator` decorator.
    """

    def __init__(self, choices, predicate):
        self.choices = choices
        self.predicate = predicate

    def __contains__(self, value):
        return self.predicate(self.choices, value)

    def __str__(self):
        return str(self.choices)

    def format(self):
        return self.choices


def range_validator(choices):
    """Decorator: turn ``fn(choices, value) -> bool`` into a range object.

    Usage mirrors the reference toolkit's API so schema modules read naturally::

        @range_validator(["auto", "hist"])
        def tree_method_range(choices, value):
            return value in choices
    """

    def wrap(fn):
        return CustomRange(choices, fn)

    return wrap


def dependencies_validator(names):
    """Decorator: attach the dependency-name list to a validator callable.

    The wrapped ``fn(value, deps_dict)`` raises UserError on violation. The
    returned object is iterable over the dependency names (the engine's
    toposort consumes that) and callable for the actual check.
    """

    def wrap(fn):
        class _DependencyCheck:
            dependencies = list(names)

            def __iter__(self):
                return iter(self.dependencies)

            def __call__(self, value, deps):
                return fn(value, deps)

        return _DependencyCheck()

    return wrap


class Hyperparameter:
    """One declared hyperparameter. Subclasses define parse + SageMaker type."""

    sagemaker_type = "FreeText"
    requires_range = False

    def __init__(
        self,
        name,
        range=None,
        dependencies=None,
        required=None,
        default=None,
        tunable=False,
        tunable_recommended_range=None,
    ):
        if required is None and default is None:
            raise exc.AlgorithmError(
                "Hyperparameter {}: declare 'required' or provide a default".format(name)
            )
        if self.requires_range and range is None:
            raise exc.AlgorithmError("Hyperparameter {}: a range is mandatory".format(name))
        self.name = name
        self.range = range
        self.dependencies = dependencies
        self.required = required
        self.default = default
        self.tunable = tunable
        self.tunable_recommended_range = tunable_recommended_range

    # -- phase 2 -------------------------------------------------------------
    def parse(self, value):
        return value

    # -- phase 3 -------------------------------------------------------------
    def validate_range(self, value):
        if self.range is not None and value not in self.range:
            raise exc.UserError(
                "Hyperparameter {}: {} is not in {}".format(self.name, value, self.range)
            )

    # -- phase 4 -------------------------------------------------------------
    def validate_dependencies(self, value, deps):
        if self.dependencies is not None:
            self.dependencies(value, deps)

    def dependency_names(self):
        if self.dependencies is None:
            return []
        return list(self.dependencies)

    # -- CreateAlgorithm metadata -------------------------------------------
    def format_range(self):
        return None

    def format_tunable_range(self):
        return None

    def format(self):
        spec = {
            "Name": self.name,
            "Description": self.name,
            "Type": self.sagemaker_type,
            "IsTunable": self.tunable,
            "IsRequired": bool(self.required),
        }
        rng = self.format_range()
        if rng is not None:
            spec["Range"] = rng
        if self.default is not None:
            spec["DefaultValue"] = str(self.default)
        return spec


class IntegerHyperparameter(Hyperparameter):
    sagemaker_type = "Integer"
    requires_range = True

    def parse(self, value):
        return int(value)

    def format_range(self):
        lo, hi = self.range.format_as_integer()
        return {"IntegerParameterRangeSpecification": {"MinValue": lo, "MaxValue": hi}}

    def format_tunable_range(self):
        if not self.tunable or self.tunable_recommended_range is None:
            return None
        lo, hi = self.tunable_recommended_range.format_as_integer()
        return {
            "IntegerParameterRanges": [
                {
                    "Name": self.name,
                    "MinValue": lo,
                    "MaxValue": hi,
                    "ScalingType": self.tunable_recommended_range.scale,
                }
            ]
        }


class ContinuousHyperparameter(Hyperparameter):
    sagemaker_type = "Continuous"
    requires_range = True

    def parse(self, value):
        return float(value)

    def format_range(self):
        lo, hi = self.range.format_as_continuous()
        return {"ContinuousParameterRangeSpecification": {"MinValue": lo, "MaxValue": hi}}

    def format_tunable_range(self):
        if not self.tunable or self.tunable_recommended_range is None:
            return None
        lo, hi = self.tunable_recommended_range.format_as_continuous()
        return {
            "ContinuousParameterRanges": [
                {
                    "Name": self.name,
                    "MinValue": lo,
                    "MaxValue": hi,
                    "ScalingType": self.tunable_recommended_range.scale,
                }
            ]
        }


class CategoricalHyperparameter(Hyperparameter):
    sagemaker_type = "Categorical"
    requires_range = True

    def _choices(self, rng):
        if isinstance(rng, (list, tuple)):
            return list(rng)
        return rng.format()

    def format_range(self):
        return {"CategoricalParameterRangeSpecification": {"Values": self._choices(self.range)}}

    def format_tunable_range(self):
        if not self.tunable or self.tunable_recommended_range is None:
            return None
        return {
            "CategoricalParameterRanges": [
                {"Name": self.name, "Values": self._choices(self.tunable_recommended_range)}
            ]
        }


class CommaSeparatedListHyperparameter(Hyperparameter):
    """``"a,b,c"`` -> ``["a", "b", "c"]``; every element must be in range."""

    requires_range = True

    def parse(self, value):
        if isinstance(value, (list, tuple)):
            return list(value)
        return str(value).split(",")

    def validate_range(self, value):
        for element in value:
            if element not in self.range:
                raise exc.UserError(
                    "Hyperparameter {}: value {} not in range {}".format(
                        self.name, value, self.range
                    )
                )


class NestedListHyperparameter(Hyperparameter):
    """``"[[0,1],[2,3]]"`` -> list of lists; every leaf must be in range."""

    requires_range = True

    def parse(self, value):
        if isinstance(value, str):
            value = ast.literal_eval(value)
        if not isinstance(value, (list, tuple)) or not all(
            isinstance(inner, (list, tuple)) for inner in value
        ):
            raise ValueError("expected a nested list, got {!r}".format(value))
        return [list(inner) for inner in value]

    def validate_range(self, value):
        for inner in value:
            for leaf in inner:
                if leaf not in self.range:
                    raise exc.UserError(
                        "Hyperparameter {}: value {} not in range {}".format(
                            self.name, value, self.range
                        )
                    )

    def format_range(self):
        lo, hi = self.range.format_as_integer()
        return {"NestedParameterRangeSpecification": {"MinValue": lo, "MaxValue": hi}}


class TupleHyperparameter(Hyperparameter):
    """``"(1, 0, -1)"`` -> tuple; every element must be in range."""

    requires_range = True

    def parse(self, value):
        if isinstance(value, tuple):
            return value
        parsed = ast.literal_eval(str(value))
        if not isinstance(parsed, (tuple, list)):
            # a bare scalar like "(1)" literal-evals to int -- accept it
            parsed = (parsed,)
        return tuple(parsed)

    def validate_range(self, value):
        for element in value:
            if element not in self.range:
                raise exc.UserError(
                    "Hyperparameter {}: value {} not in range {}".format(
                        self.name, value, self.range
                    )
                )

    def format_range(self):
        return {"TupleParameterRangeSpecification": {"Values": self.range}}


class Hyperparameters:
    """Registry of declared hyperparameters + the 4-phase validator."""

    def __init__(self, *declared):
        self._schema = {hp.name: hp for hp in declared}
        self._aliases = {}

    def __getitem__(self, name):
        return self._schema[name]

    def __contains__(self, name):
        return name in self._schema

    def names(self):
        return list(self._schema)

    def declare_alias(self, canonical, alias):
        if canonical not in self._schema:
            raise exc.AlgorithmError(
                "Alias target {} is not a declared hyperparameter".format(canonical)
            )
        self._aliases[alias] = canonical

    def _canonicalize(self, user_values):
        return {self._aliases.get(name, name): value for name, value in user_values.items()}

    def _dependency_order(self, names):
        """Kahn toposort restricted to the provided names.

        A hyperparameter is validated only after every dependency that is
        itself present has been validated.
        """
        present = set(names)
        incoming = {}
        dependents = {n: [] for n in names}
        for n in names:
            deps = [d for d in self._schema[n].dependency_names() if d in present]
            incoming[n] = len(deps)
            for d in deps:
                dependents[d].append(n)
        ready = sorted(n for n in names if incoming[n] == 0)
        order = []
        while ready:
            n = ready.pop()
            order.append(n)
            for m in dependents[n]:
                incoming[m] -= 1
                if incoming[m] == 0:
                    ready.append(m)
        if len(order) != len(present):
            raise exc.AlgorithmError("Hyperparameter dependency graph has a cycle")
        return order

    def validate(self, user_hyperparameters):
        values = self._canonicalize(dict(user_hyperparameters))

        # Phase 1: required / defaults.
        for name, hp in self._schema.items():
            if name not in values:
                if hp.required:
                    raise exc.UserError("Missing required hyperparameter: {}".format(name))
                if hp.default is not None:
                    values[name] = hp.default

        # Phase 2: parse strings to typed values.
        typed = {}
        for name, raw in values.items():
            hp = self._schema.get(name)
            if hp is None:
                raise exc.UserError("Extraneous hyperparameter found: {}".format(name))
            try:
                typed[name] = hp.parse(raw)
            except (ValueError, SyntaxError, TypeError) as e:
                raise exc.UserError(
                    "Hyperparameter {}: could not parse value".format(name), caused_by=e
                )

        # Phase 3: range membership.
        for name, value in typed.items():
            try:
                self._schema[name].validate_range(value)
            except exc.UserError:
                raise
            except Exception as e:
                raise exc.AlgorithmError(
                    "Hyperparameter {}: unexpected failure validating {}".format(name, value),
                    caused_by=e,
                )

        # Phase 4: cross-parameter dependencies, dependencies first.
        validated = {}
        for name in self._dependency_order(typed.keys()):
            hp = self._schema[name]
            deps = {d: validated[d] for d in hp.dependency_names() if d in validated}
            hp.validate_dependencies(typed[name], deps)
            validated[name] = typed[name]
        return validated

    def format(self):
        return [hp.format() for hp in self._schema.values()]

    def format_tunable(self):
        specs = {}
        for hp in self._schema.values():
            rng = hp.format_tunable_range()
            if rng:
                for kind, entries in rng.items():
                    specs.setdefault(kind, []).extend(entries)
        return specs
