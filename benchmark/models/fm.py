"""The program's side of an ``fm`` configuration: the port's
``FMLearner`` with the configuration's settings, parameters drawn from
the seed, and a serving artifact written with the port's
``save_model``."""

from __future__ import annotations

import numpy as np
import torch


def learner(config: dict, device: str):
    from dmlc_core_tpu_torch.models.fm import FMLearner
    m = config["model"]
    return FMLearner(config["features"], k=m["k"], objective=m["objective"],
                     learning_rate=m["learning_rate"], l2=m.get("l2", 0.0),
                     init_scale=m["init_scale"], device=device)


def init(config: dict, seed: int, device: str):
    """The learner's own init (``b``, ``w`` zero, ``v`` ~
    N(0, init_scale²)), drawn in one call from a generator on the
    device."""
    from dmlc_core_tpu_torch.models.fm import FMParams
    m = config["model"]
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    v = m["init_scale"] * torch.randn((config["features"], m["k"]),
                                      generator=g, device=device,
                                      dtype=torch.float32)
    return FMParams(b=torch.zeros((), device=device),
                    w=torch.zeros((config["features"],), device=device),
                    v=v)


def leaves(params) -> dict:
    return {k: getattr(params, k).detach().cpu().numpy().copy()
            for k in ("b", "w", "v")}


def serving_params(config: dict, seed: int) -> dict:
    """A served model's parameters from the seed, on the host (the
    scoring server loads them onto the card itself): ``b`` and ``w`` as
    a trained model's, ``v`` at the serving scale."""
    m = config["model"]
    s = config["serving"]
    rng = np.random.default_rng(seed)
    return {"b": np.float32(s["bias"]),
            "w": (s["w_scale"] * rng.standard_normal(
                config["features"], dtype=np.float32)),
            "v": (s["v_scale"] * rng.standard_normal(
                (config["features"], m["k"]), dtype=np.float32))}


def save_serving(path: str, config: dict, params: dict) -> None:
    from dmlc_core_tpu_torch.serving.model import save_model
    save_model(path, "fm", params, config["features"],
               objective=config["model"]["objective"])
