"""Handler services: the model_fn / input_fn / predict_fn / output_fn
pipeline of the MMS handler contract.

* ``AlgorithmHandlerService``: the default handlers over ``serve_utils``
  (multi-model endpoints and batch transform use these);
* ``UserModuleHandlerService``: script mode, where ``model_fn`` must come
  from the user module and each other hook overrides its default.

Both expose ``handle(payload, content_type, accept, model_dir)``, so any
front end can run the same pipeline. The models load onto ``device`` (CUDA
unless given).
"""

import numpy as np

from .._device import resolve_device
from ..toolkit import exceptions as exc
from . import encoder, serve_utils


class InferenceError(Exception):
    def __init__(self, message, status):
        super().__init__(message)
        self.status = status


class AlgorithmHandlerService:
    """The default algorithm-mode handlers."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._model = None
        self._format = None

    def model_fn(self, model_dir):
        self._model, self._format = serve_utils.get_loaded_booster(
            model_dir, serve_utils.is_ensemble_enabled(), device=self.device)
        return self._model

    def input_fn(self, input_data, content_type):
        try:
            return serve_utils.parse_content_data(input_data, content_type)
        except Exception as e:
            raise InferenceError(str(e), 415)

    def predict_fn(self, data, model):
        dtest, content_type = data
        first = model[0] if isinstance(model, list) else model
        try:
            return serve_utils.predict(model, self._format, dtest, content_type,
                                       objective=first.objective_name)
        except Exception as e:
            raise InferenceError(str(e), 400)

    def output_fn(self, prediction, accept):
        preds_list = np.asarray(prediction).tolist()
        if accept == "application/json":
            return serve_utils.encode_predictions_as_json(preds_list), accept
        if accept == "application/jsonlines":
            body = encoder.json_to_jsonlines({"predictions": [{"score": p} for p in preds_list]})
            return body, accept
        if accept == "text/csv":
            # proper csv rows, one a prediction (multi-output rows joined by
            # commas)
            body = "\n".join(
                ",".join(map(str, p)) if isinstance(p, list) else str(p) for p in preds_list)
            return body, accept
        raise InferenceError("Accept type {} is not supported".format(accept), 406)

    def handle(self, payload, content_type, accept, model_dir):
        if self._model is None:
            self.model_fn(model_dir)
        data = self.input_fn(payload, content_type)
        preds = self.predict_fn(data, self._model)
        return self.output_fn(preds, accept)


class UserModuleHandlerService(AlgorithmHandlerService):
    """Script-mode handlers: the user module's hooks override; its model_fn
    is required."""

    def __init__(self, user_module=None, device=None):
        super().__init__(device=device)
        self.user_module = user_module

    def _hook(self, name):
        return getattr(self.user_module, name, None) if self.user_module else None

    def model_fn(self, model_dir):
        hook = self._hook("model_fn")
        if hook is None:
            raise exc.UserError(
                "A model_fn implementation is required in the user module for "
                "multi-model endpoints in script mode.")
        self._model = hook(model_dir)
        self._format = "user"
        return self._model

    def input_fn(self, input_data, content_type):
        hook = self._hook("input_fn")
        if hook is not None:
            return hook(input_data, content_type)
        return super().input_fn(input_data, content_type)

    def predict_fn(self, data, model):
        hook = self._hook("predict_fn")
        if hook is not None:
            return hook(data, model)
        return super().predict_fn(data, model)

    def output_fn(self, prediction, accept):
        hook = self._hook("output_fn")
        if hook is not None:
            out = hook(prediction, accept)
            return out if isinstance(out, tuple) else (out, accept)
        return super().output_fn(prediction, accept)

    def handle(self, payload, content_type, accept, model_dir):
        transform = self._hook("transform_fn")
        if transform is not None:
            if self._model is None:
                self.model_fn(model_dir)
            out = transform(self._model, payload, content_type, accept)
            return out if isinstance(out, tuple) else (out, accept)
        return super().handle(payload, content_type, accept, model_dir)
