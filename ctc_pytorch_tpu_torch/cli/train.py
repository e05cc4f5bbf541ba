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
in the graphs of a fused epoch too.  With ``log_dir`` set, the log also
goes to ``<log_dir>/<exp_name>.log``, as in the JAX stage 2.

``--data-parallel`` trains on every rank that ``torchrun`` started, one
process a rank (``parallel/``): ``torchrun --nproc-per-node N -m
ctc_pytorch_tpu_torch.cli.train --conf ... --data-parallel`` on N cards over
NCCL, or ``--device cpu --dist-backend gloo`` on the CPU.  Each rank takes
``cuda:LOCAL_RANK``, unless ``--device`` names one card for all of them
(gloo ranks can share a card; NCCL refuses two ranks on one device).  Every
rank reads the whole scp lists and builds the same global batches; each
steps on its ``batch_size / world`` rows, which must divide.  Only rank 0
logs and writes.  With ``WORLD_SIZE`` unset or 1 it is the single-process
run, as the JAX flag is on one device.  A gloo group cannot run a fused
epoch on the card (``Trainer`` raises): set ``fused_epoch: false`` there.
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
from ctc_pytorch_tpu_torch.parallel.distributed import initialize, shutdown
from ctc_pytorch_tpu_torch.train.loop import Trainer, quiet
from ctc_pytorch_tpu_torch.utils import init_file_logger
from ctc_pytorch_tpu_torch.vocab import Vocab


def build_loaders(cfg, vocab, log=print,
                  device: str | torch.device = "cuda", group=None):
    """(train_loader, dev_loader) as the JAX package's stage 2 builds them
    (``ctc_pytorch_tpu/cli/train.py:73-103``): ``DeviceCachedLoader``s on
    ``device`` where the cache fits its budget, else ``PrefetchLoader``s
    with ``host_prefetch``, else the host loaders.  With a data-parallel
    ``group`` the device loaders give the rank's rows of each batch (the
    host loaders give whole batches, which the trainer cuts)."""
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
            return (DeviceCachedLoader(train_loader, dev, group),
                    DeviceCachedLoader(dev_loader, dev, group))
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
        return (PrefetchLoader(train_loader, dev, group=group),
                PrefetchLoader(dev_loader, dev, group=group))
    return train_loader, dev_loader


def train(cfg, *, device: str | torch.device = "cuda", resume=None,
          num_epoches=None, log=print, group=None):
    """Train ``cfg``'s model; returns ``(trainer, best package path)``.
    ``group``: this rank's ``DataGroup`` of a data-parallel run."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if group is not None and cfg.batch_size % group.world:
        raise SystemExit(
            f"--data-parallel: batch_size={cfg.batch_size} must be a multiple "
            f"of the {group.world} ranks (each steps on batch_size / world "
            f"rows of every batch)")
    writer = group is None or group.rank == 0
    if not writer:
        log = quiet
    vocab = Vocab(cfg.vocab_file)
    train_loader, dev_loader = build_loaders(cfg, vocab, log, dev, group)
    # 863 configs declare num_class explicitly (blank added on top);
    # otherwise the vocab decides
    n_class = cfg.num_class + 1 if cfg.num_class > 0 else vocab.n_words
    spec = ModelSpec.from_config(cfg, num_class=n_class)
    trainer = Trainer(cfg, spec, device=dev,
                      frontend_fn=frontend_fn_from_config(cfg), group=group)
    if resume:
        trainer.resume(resume)
    best = trainer.fit(train_loader, dev_loader, num_epoches=num_epoches,
                       log=log)
    # the best-checkpoint path goes into a config snapshot in the experiment
    # directory, not into the user's file
    cfg.model_file = str(best)
    if writer:
        cfg.to_yaml(trainer.out_dir / "config_used.yaml")
    log(f"End training, best model saved to {best}")
    return trainer, best


def main(argv=None):
    p = argparse.ArgumentParser(description="cnn_lstm_ctc training (torch)")
    p.add_argument("--conf", default="conf/ctc_config.yaml")
    p.add_argument("--resume", default=None,
                   help="path to a resume checkpoint (.npz)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; with --data-parallel each rank takes "
                        "cuda:LOCAL_RANK unless an index is given), or cpu "
                        "(the plain PyTorch path)")
    p.add_argument("--data-parallel", action="store_true",
                   help="train on every rank torchrun started, each on its "
                        "rows of every batch")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="the ranks' collectives: nccl (default on cuda) or "
                        "gloo (default on cpu)")
    p.add_argument("--dist-init-method", default=None,
                   help="where the ranks meet (default: torchrun's "
                        "environment, env://); e.g. file:///shared/store")
    args = p.parse_args(argv)
    cfg = load_config(args.conf)
    group = None
    if args.data_parallel:
        backend = args.dist_backend or (
            "gloo" if torch.device(args.device).type == "cpu" else "nccl")
        group = initialize(backend, args.dist_init_method,
                           device=args.device)
    try:
        log = print
        if cfg.log_dir and (group is None or group.rank == 0):
            log = init_file_logger(cfg.log_dir, cfg.exp_name).info
        device = args.device if group is None else group.device
        return train(cfg, device=device, resume=args.resume, log=log,
                     group=group)[1]
    finally:
        shutdown(group)


if __name__ == "__main__":
    main()
