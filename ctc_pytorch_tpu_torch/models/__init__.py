from ctc_pytorch_tpu_torch.models.ctc_model import CTCModel, ModelSpec  # noqa: F401
