"""PyTorch/CUDA port of dmlc_core_tpu for one NVIDIA Hopper GPU.

The JAX package beside it is the reference: every module here mirrors a
module there by name, and the tests run both on the same inputs. The
port imports torch, numpy and the standard library only — nothing of
``dmlc_core_tpu`` and nothing of JAX. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; without CUDA and without an explicit
device they raise instead of quietly running on the CPU.
"""

__all__ = ["base", "telemetry"]
