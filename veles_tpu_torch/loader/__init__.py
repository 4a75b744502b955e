"""Data-loading stack (port of ``veles_tpu/loader/``)."""

from veles_tpu_torch.loader.base import (CLASS_NAME, TEST, TRAIN,  # noqa: F401
                                         VALID, ILoader, Loader,
                                         UserLoaderRegistry)
from veles_tpu_torch.loader.fullbatch import (FullBatchLoader,  # noqa: F401
                                              FullBatchLoaderMSE)
from veles_tpu_torch.loader.file_loader import (  # noqa: F401
    FileListLoaderBase, scan_files)
from veles_tpu_torch.loader.image import (FullBatchImageLoader,  # noqa: F401
                                          ImageLoader, decode_image)
from veles_tpu_torch.loader.hdf5 import HDF5Loader  # noqa: F401
from veles_tpu_torch.loader.pickles import PicklesLoader  # noqa: F401
from veles_tpu_torch.loader.saver import (MinibatchesLoader,  # noqa: F401
                                          MinibatchesSaver,
                                          read_minibatches)
from veles_tpu_torch.loader.interactive import (  # noqa: F401
    InteractiveLoader, QueueLoader, StreamLoader, send_stream)
from veles_tpu_torch.loader.prefetch import (PrefetchedBatch,  # noqa: F401
                                             PrefetchingServer)
from veles_tpu_torch.loader.audio import (AudioFileLoader,  # noqa: F401
                                          decode_audio)
from veles_tpu_torch.loader.hdfs import (HDFSTextLoader,  # noqa: F401
                                         open_hdfs_lines)
