"""The port's QA lane: lint, concurrency and contract analysis, API docs.

Counterparts of the repo's ``scripts/srcwalk.py``, ``lint.py``,
``contracts.py``, ``analyze.py`` and ``gendoc.py``, pointed at
``dmlc_core_tpu_torch/``, the port's tests, ``chip_smoke.py`` and the two C
boundaries the port binds with ctypes (``cpp/src/capi.cc`` and
``csrc/*.cu``)::

    python -m dmlc_core_tpu_torch.qa.lint      # exit 0 when clean
    python -m dmlc_core_tpu_torch.qa.analyze   # exit code = finding count
    python -m dmlc_core_tpu_torch.qa.gendoc    # writes doc/torch/*.md

The modules use the standard library only, and the package is not imported
by ``dmlc_core_tpu_torch`` itself.
"""
