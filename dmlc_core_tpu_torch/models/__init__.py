"""Models of the port: the linear learner, the factorization machine, and
the LM lane's DP x SP (ring attention) and DP x TP (+MoE) transformers."""

from dmlc_core_tpu_torch.models.fm import FMLearner, FMParams  # noqa: F401
from dmlc_core_tpu_torch.models.linear import LinearLearner  # noqa: F401
from dmlc_core_tpu_torch.models.tp_transformer import (  # noqa: F401
    TPTransformerConfig, TPTransformerLM)
from dmlc_core_tpu_torch.models.transformer import (  # noqa: F401
    TransformerConfig, TransformerLM)
