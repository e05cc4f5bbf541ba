"""Corpus I/O of stage 0/1: the TIMIT walk and phone folding (``timit``,
``phones``), the SPHERE/WAV readers (``sphere``) and the shorten decoder
(``shorten``), copies of ``ctc_pytorch_tpu/data/prep/``."""

from ctc_pytorch_tpu_torch.data.prep.phones import (  # noqa: F401
    PHONE_MAP_60_48_39,
    normalize_phones,
    phone_map,
)
from ctc_pytorch_tpu_torch.data.prep.sphere import (  # noqa: F401
    audio_num_samples,
    read_audio,
    read_sphere,
    read_wav,
    write_wav,
)
from ctc_pytorch_tpu_torch.data.prep.timit import prepare_timit  # noqa: F401
