"""The audio frontend as torch ops: Kaldi features (``features``), global
CMVN (``cmvn``), context splicing and frame skipping (``splice``), F_Mel
warping (``fmel``) and the waveform-in step frontend (``e2e``).
Counterparts of ``ctc_pytorch_tpu/frontend/``; XLA code there, so no
hand-written kernel here: cuFFT and cuBLAS through torch on the card."""

from ctc_pytorch_tpu_torch.frontend.cmvn import (  # noqa: F401
    CmvnStats,
    accumulate_cmvn,
    apply_cmvn,
    compute_global_cmvn,
    finalize_cmvn,
    init_cmvn,
)
from ctc_pytorch_tpu_torch.frontend.features import (  # noqa: F401
    FrontendConfig,
    add_deltas,
    dct_matrix,
    fbank,
    frame_signal,
    log_spectrum_librosa,
    mel_filterbank,
    mfcc,
    num_frames,
    spectrogram,
)
from ctc_pytorch_tpu_torch.frontend.splice import (  # noqa: F401
    make_context,
    pad_to_downsample,
    skip_frames,
    splice_and_skip,
)
