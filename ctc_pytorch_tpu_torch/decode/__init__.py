from ctc_pytorch_tpu_torch.decode.greedy import GreedyDecoder  # noqa: F401
from ctc_pytorch_tpu_torch.decode.metrics import Scorer  # noqa: F401
