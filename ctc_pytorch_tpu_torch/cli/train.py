"""Stage 2: acoustic model training.

Counterpart of ``ctc_pytorch_tpu/cli/train.py``: ``python -m
ctc_pytorch_tpu_torch.cli.train --conf conf/ctc_config.yaml`` — same flag,
same YAML.  Builds vocab, datasets and loaders from the config, trains with
the plateau scheduler and writes the best package to
``<checkpoint_dir>/<exp_name>/ctc_best_model.npz``, which ``cli.test`` of
either package decodes.

Runs on ``cuda`` unless ``--device cpu`` is given; without a card it raises.
TF32 is off for matmuls and cuDNN convolutions, so an fp32 config trains in
full fp32 like the JAX reference.  Where the JAX stage 2 caches the dataset
on the device (``device_cache`` on and the cache within
``device_cache_max_gb``), the loaders are ``DeviceCachedLoader``s, and with
``fused_epoch`` the trainer runs its passes from captured CUDA graphs over
them; where it streams from the host with ``host_prefetch``, they are
``PrefetchLoader``s.  ``feature_type: waveform`` configs train from raw
samples with the frontend inside the step (``frontend/e2e.py``, the CMVN
stats of ``<data_dir>/global_fbank_cmvn.npz`` where stage 1 wrote them),
in the graphs of a fused epoch too.  ``--data-parallel`` is not ported.
With ``log_dir`` set, the log also goes to ``<log_dir>/<exp_name>.log``, as
in the JAX stage 2.
"""

from __future__ import annotations

import argparse

import torch

from ctc_pytorch_tpu_torch import resolve_device
from ctc_pytorch_tpu_torch.config import load_config
from ctc_pytorch_tpu_torch.data import (
    DeviceCachedLoader,
    PrefetchLoader,
    SpeechDataLoader,
    SpeechDataset,
    estimate_bytes,
)
from ctc_pytorch_tpu_torch.frontend.e2e import frontend_fn_from_config
from ctc_pytorch_tpu_torch.models.ctc_model import ModelSpec
from ctc_pytorch_tpu_torch.train.loop import Trainer
from ctc_pytorch_tpu_torch.utils import init_file_logger
from ctc_pytorch_tpu_torch.vocab import Vocab


def build_loaders(cfg, vocab, log=print,
                  device: str | torch.device = "cuda"):
    """(train_loader, dev_loader) as the JAX package's stage 2 builds them
    (``ctc_pytorch_tpu/cli/train.py:73-103``): ``DeviceCachedLoader``s on
    ``device`` where the cache fits its budget, else ``PrefetchLoader``s
    with ``host_prefetch``, else the host loaders."""
    dev = resolve_device(device)
    train_ds = SpeechDataset(vocab, cfg.train_scp_path, cfg.train_lab_path, cfg)
    dev_ds = SpeechDataset(vocab, cfg.valid_scp_path, cfg.valid_lab_path, cfg)
    train_ds.preload(cfg.num_workers)
    dev_ds.preload(cfg.num_workers)
    train_loader = SpeechDataLoader(
        train_ds, cfg.batch_size, shuffle=cfg.shuffle_train,
        num_buckets=cfg.num_buckets, seed=cfg.seed, mode=cfg.batch_mode,
    )
    dev_loader = SpeechDataLoader(
        dev_ds, cfg.batch_size, shuffle=False, num_buckets=cfg.num_buckets,
        seed=cfg.seed, mode=cfg.batch_mode,
    )
    if cfg.device_cache:
        # the budget check from host-side bucket shapes, before anything is
        # uploaded
        est = estimate_bytes(train_loader) + estimate_bytes(dev_loader)
        if est <= cfg.device_cache_max_gb * (1 << 30):
            return (DeviceCachedLoader(train_loader, dev),
                    DeviceCachedLoader(dev_loader, dev))
        if est >= 1 << 62:
            log("WARNING: device cache disabled: num_buckets=0 "
                "(reference-exact per-batch shapes) is not cacheable; "
                "falling back to host streaming")
        else:
            log(f"WARNING: device cache disabled: estimated "
                f"{est / (1 << 30):.2f} GB exceeds device_cache_max_gb="
                f"{cfg.device_cache_max_gb}; falling back to host streaming")
    if cfg.host_prefetch:
        # whenever batches stream from the host: the cache off by config or
        # over its budget
        return (PrefetchLoader(train_loader, dev),
                PrefetchLoader(dev_loader, dev))
    return train_loader, dev_loader


def train(cfg, *, device: str | torch.device = "cuda", resume=None,
          num_epoches=None, log=print):
    """Train ``cfg``'s model; returns ``(trainer, best package path)``."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vocab = Vocab(cfg.vocab_file)
    train_loader, dev_loader = build_loaders(cfg, vocab, log, dev)
    # 863 configs declare num_class explicitly (blank added on top);
    # otherwise the vocab decides
    n_class = cfg.num_class + 1 if cfg.num_class > 0 else vocab.n_words
    spec = ModelSpec.from_config(cfg, num_class=n_class)
    trainer = Trainer(cfg, spec, device=dev,
                      frontend_fn=frontend_fn_from_config(cfg))
    if resume:
        trainer.resume(resume)
    best = trainer.fit(train_loader, dev_loader, num_epoches=num_epoches,
                       log=log)
    # the best-checkpoint path goes into a config snapshot in the experiment
    # directory, not into the user's file
    cfg.model_file = str(best)
    cfg.to_yaml(trainer.out_dir / "config_used.yaml")
    log(f"End training, best model saved to {best}")
    return trainer, best


def main(argv=None):
    p = argparse.ArgumentParser(description="cnn_lstm_ctc training (torch)")
    p.add_argument("--conf", default="conf/ctc_config.yaml")
    p.add_argument("--resume", default=None,
                   help="path to a resume checkpoint (.npz)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch path)")
    args = p.parse_args(argv)
    cfg = load_config(args.conf)
    log = print
    if cfg.log_dir:
        log = init_file_logger(cfg.log_dir, cfg.exp_name).info
    return train(cfg, device=args.device, resume=args.resume, log=log)[1]


if __name__ == "__main__":
    main()
