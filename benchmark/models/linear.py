"""The program's side of a ``linear`` configuration: the port's
``LinearLearner`` with the configuration's settings, and parameters
drawn from the seed on the learner's device."""

from __future__ import annotations

import torch


def learner(config: dict, device: str):
    from dmlc_core_tpu_torch.models.linear import LinearLearner
    m = config["model"]
    return LinearLearner(config["features"], objective=m["objective"],
                         learning_rate=m["learning_rate"],
                         l2=m.get("l2", 0.0), margin_path=m["margin_path"],
                         device=device)


def init(config: dict, seed: int, device: str):
    """``w`` ~ N(0, init_scale²) from a generator on the device, ``b`` 0.
    (Nonzero weights keep every margin off 0, where the port's logistic
    gradient follows the reference package's subgradient, not the
    derivative.)"""
    from dmlc_core_tpu_torch.models.linear import LinearParams
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    w = config["model"]["init_scale"] * torch.randn(
        (config["features"],), generator=g, device=device,
        dtype=torch.float32)
    return LinearParams(w=w, b=torch.zeros((), device=device))


def leaves(params) -> dict:
    return {"w": params.w.detach().cpu().numpy().copy(),
            "b": params.b.detach().cpu().numpy().copy()}
