"""PyTorch/CUDA port of dmlc_core_tpu for one NVIDIA Hopper GPU.

The JAX package beside it is the reference: every module here mirrors a
module there by name, and the tests run both on the same inputs. The
port imports torch, numpy and the standard library only — nothing of
``dmlc_core_tpu`` and nothing of JAX. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; without CUDA and without an explicit
device they raise instead of quietly running on the CPU.

Importing the package installs the reference's log handler on the
``dmlc_core_tpu_torch`` logger (``[HH:MM:SS] LEVEL message`` on stderr,
INFO and up), which every module's logger reaches, and loads neither
torch nor numpy: the names below are the reference's package exports.
"""

__version__ = "0.1.0"

from dmlc_core_tpu_torch.base import (DMLCError, check,  # noqa: E402
                                      check_eq, get_env, set_env)
from dmlc_core_tpu_torch.params import (Parameter, ParamError,  # noqa: E402
                                        field)
from dmlc_core_tpu_torch.registry import Registry  # noqa: E402

__all__ = [
    "DMLCError",
    "check",
    "check_eq",
    "get_env",
    "set_env",
    "Parameter",
    "field",
    "ParamError",
    "Registry",
    "__version__",
    "base",
    "telemetry",
]
