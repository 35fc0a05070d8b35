"""Data parallelism and the two-stage serving pipeline (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/parallel/``: ``mesh.py``
(process groups, the ``(data, model)`` device mesh, the batch and state
placement), ``collectives.py`` (the explicit all-reduces of the train steps
and of SyncBatchNorm, the all-gather of data-parallel serving) and
``pp.py`` (backbone and FPN + head on two devices).  Tensor parallelism
and spatial partitioning (``tp.py``, ``sp.py``) are not ported (ROADMAP.md
queue 1 item 11b).
"""
