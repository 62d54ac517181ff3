"""ray_tpu_torch.data — distributed datasets on the object plane.

Parity: reference ``python/ray/data``.  See ``dataset.py`` for the block
and execution model.
"""

from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata  # noqa: F401
from ray_tpu_torch.data.context import DataContext  # noqa: F401
from ray_tpu_torch.data.dataset import ActorPoolStrategy, Dataset, GroupedDataset  # noqa: F401
from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline  # noqa: F401
from ray_tpu_torch.data.streaming import (  # noqa: F401
    StreamingExecutor,
    StreamingShuffle,
    StreamShard,
)
from ray_tpu_torch.data.read_api import (  # noqa: F401
    from_arrow,
    from_huggingface,
    from_items,
    from_numpy,
    from_pandas,
    range,
    range_tensor,
    read_binary_files,
    read_csv,
    read_images,
    read_json,
    read_mongo,
    read_numpy,
    read_parquet,
    read_sql,
    read_text,
    read_tfrecords,
    read_webdataset,
)
from ray_tpu_torch.data import preprocessors  # noqa: F401
