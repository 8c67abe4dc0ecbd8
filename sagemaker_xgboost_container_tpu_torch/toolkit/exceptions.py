"""Error taxonomy: ``UserError`` (the customer can fix it),
``AlgorithmError`` (a defect in this framework) and ``PlatformError`` (the
hosting platform failed).

Each carries an optional ``caused_by`` exception whose message is appended so
the original failure is never lost when re-raising across layers.
"""


class BaseToolkitError(Exception):
    """Common machinery: message + failure prefix + optional cause chaining."""

    def __init__(self, message=None, caused_by=None, failure_prefix="Algorithm Error"):
        formatted = self._assemble(message, caused_by, failure_prefix)
        super().__init__(formatted)
        self.message = formatted
        self.caused_by = caused_by

    @staticmethod
    def _assemble(message, caused_by, failure_prefix):
        parts = [failure_prefix]
        if message:
            parts.append(": {}".format(message))
        if caused_by is not None:
            parts.append(" (caused by {})".format(type(caused_by).__name__))
        out = "".join(parts)
        if caused_by is not None:
            detail = str(caused_by)
            if detail:
                out += "\n\nCaused by: {}".format(detail)
        return out

    def public_failure_message(self):
        """Message safe to write to the platform failure file."""
        return self.message


class UserError(BaseToolkitError):
    """The customer supplied something invalid and can fix it themselves."""

    def __init__(self, message, caused_by=None):
        super().__init__(message, caused_by, failure_prefix="Customer Error")


class AlgorithmError(BaseToolkitError):
    """A defect in this framework."""

    def __init__(self, message, caused_by=None):
        super().__init__(message, caused_by, failure_prefix="Algorithm Error")


class PlatformError(BaseToolkitError):
    """The surrounding platform (SageMaker, filesystem contract) failed."""

    def __init__(self, message, caused_by=None):
        super().__init__(message, caused_by, failure_prefix="Platform Error")


def convert_to_algorithm_error(error):
    """Wrap an arbitrary exception, passing through ones already classified."""
    if isinstance(error, (UserError, AlgorithmError, PlatformError)):
        return error
    return AlgorithmError(str(error), caused_by=error)
