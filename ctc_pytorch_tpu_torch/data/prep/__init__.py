"""Corpus I/O of stage 0/1: the SPHERE/WAV readers (``sphere``) and the
shorten decoder (``shorten``), copies of ``ctc_pytorch_tpu/data/prep/``."""

from ctc_pytorch_tpu_torch.data.prep.sphere import (  # noqa: F401
    audio_num_samples,
    read_audio,
    read_sphere,
    read_wav,
    write_wav,
)
