from ctc_pytorch_tpu_torch.decode.greedy import GreedyDecoder  # noqa: F401
from ctc_pytorch_tpu_torch.decode.metrics import Scorer  # noqa: F401
from ctc_pytorch_tpu_torch.decode.ngram_lm import LanguageModel, train_bigram_lm  # noqa: F401
from ctc_pytorch_tpu_torch.decode.beam import BeamDecoder, ctc_beam_search  # noqa: F401
