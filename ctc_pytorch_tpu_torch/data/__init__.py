from ctc_pytorch_tpu_torch.data.batching import (  # noqa: F401
    Batch,
    BucketBatcher,
    DeviceCachedLoader,
    GroupedLoader,
    PrefetchLoader,
    SpeechDataLoader,
    collate,
    estimate_bytes,
)
from ctc_pytorch_tpu_torch.data.dataset import SpeechDataset  # noqa: F401
