"""Data, tensor, spatial and pipeline parallelism (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/parallel/``: ``mesh.py``
(process groups, the ``(data, model)`` device mesh, the batch and state
placement), ``collectives.py`` (the explicit all-reduces of the train steps
and of SyncBatchNorm, the all-gather of data-parallel serving, and the
autograd all-gathers and halo exchange of the two model-axis layouts),
``tp.py`` (tensor parallelism: channel-sharded state and convs), ``sp.py``
(spatial partitioning: row bands of the images) and ``pp.py`` (backbone
and FPN + head on two devices).
"""
