"""Device data path: host batches to CUDA tensors, and the process meshes
(the port's counterpart of ``dmlc_core_tpu/tpu``)."""

from dmlc_core_tpu_torch.device.device_iter import (  # noqa: F401
    DenseBatch, DenseRecHostBatcher, DeviceRowBlockIter,
    ElasticDeviceRowBlockIter, HostBatcher, NativeHostBatcher, PaddedBatch)
from dmlc_core_tpu_torch.device.sharding import (  # noqa: F401
    data_mesh, host_data_mesh, local_device_count, process_part)
