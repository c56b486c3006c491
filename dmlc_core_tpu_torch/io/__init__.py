"""I/O layer: the native binding (the port's own build of the shared C++
core) and dataset conversion. Both import numpy and no torch."""

from dmlc_core_tpu_torch.io.convert import (  # noqa: F401
    build_recordio_index, rows_to_dense_recordio, rows_to_recordio)
from dmlc_core_tpu_torch.io.native import (  # noqa: F401
    NativeBatcher, NativeDenseRecBatcher, NativeInputSplit, NativeParser,
    NativeRecordIOReader, NativeRecordIOWriter, NativeStream, RowBlock,
    list_directory, parser_formats_doc, path_info, set_webhdfs_auth_header,
    set_webhdfs_delegation_token)
