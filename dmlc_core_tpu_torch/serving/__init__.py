"""Online scoring plane: batched, admission-controlled model serving.

The port of ``dmlc_core_tpu/serving/``: an HTTP front end on a selectors
loop accepts libsvm/csv payloads on ``POST /score``, micro-batches them
through the native parser, pads them into fixed buckets, and answers
per-request scores from the linear/FM forward on the device (``cuda``
unless the caller asks for the CPU). Bounded admission with lateness
shedding, a circuit breaker on forward failures, last-good reload and a
draining shutdown behave as in the reference (doc/serving.md).
"""

from dmlc_core_tpu_torch.serving.model import ScoringModel, save_model
from dmlc_core_tpu_torch.serving.server import ScoringServer, ServingConfig

__all__ = ["ScoringModel", "ScoringServer", "ServingConfig", "save_model"]
