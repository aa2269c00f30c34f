"""Input pipeline: disjoint rank shards, static batches, device prefetch,
and TFRecord shards read through a native host library."""

from bluefog_tpu_torch.data.loader import (  # noqa: F401
    ArraySource,
    DistributedLoader,
    Subset,
    SyntheticClassificationSource,
    prefetch_to_device,
)
from bluefog_tpu_torch.data.tfrecord import (  # noqa: F401
    TFRecordSource,
    TFRecordWriter,
    crc32c,
    decode_example,
    encode_example,
    image_classification_decoder,
    load_native,
    native_loaded,
    read_records,
    write_image_classification_shards,
)
