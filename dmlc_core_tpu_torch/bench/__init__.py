"""The port's headline benchmark: ``python -m dmlc_core_tpu_torch.bench``.

The counterpart of the reference's ``bench.py``: the same flags and the
same one-line JSON result (``{"metric": "higgs_<fmt>_ingest_rows_per_sec",
"value", "unit", "vs_baseline", "extras"}``), measured through the port on
the card (``--device cpu`` runs it on the CPU; ``--parse-only`` and
``--no-device`` measure the host alone). Without CUDA and without one of
those flags it exits non-zero: it never falls back to host numbers on its
own.

Modules, each the counterpart of a part of ``bench.py`` or
``scripts/loadrig.py``: :mod:`.datasets` (the seeded HIGGS-shaped files,
byte for byte the reference's), :mod:`.record` (provenance and the
regression record ``scripts/benchdiff.py`` reads), :mod:`.host_lanes`
(host parse rates, thread scaling, the text, cache, RecordIO and binary
host lanes), :mod:`.ingest` (the headline: file to card with a consuming
reduction, and its bandwidth share), :mod:`.kernel_probe` (the
hand-written CSR to dense kernel against the library call),
:mod:`.device_lane` (``LinearLearner`` on the device iterator),
:mod:`.loadrig` (the load generator and parse clients),
:mod:`.serving_lane`, :mod:`.remote_lane` (out-of-process mock origins),
:mod:`.mesh_worker` and :mod:`.mesh_lane` (a gloo world under the
tracker, and its recovery from a SIGKILL).
"""
