"""The CTC acoustic model: optional CNN stack -> stacked LSTM, GRU or tanh-RNN
layers, bidirectional or not -> BN + Linear -> log-softmax, in eval and in
train mode.

Counterpart of ``ctc_pytorch_tpu/models/ctc_model.py``.  ``ModelSpec`` is a
copy (the checkpoint's model description); ``CTCModel`` is an
``nn.Module`` whose ``state_dict`` keys are the JAX tree paths
(``cnn.0.w``, ``rnns.1.bn.mean``, ``fc.w``, ...).

Data parallel: with a ``group`` (``parallel/mesh.py``) the batchmax pad
dynamics take the global batch's max (``all_max``, the JAX ``pmax`` of
``ctc_model.py:165-166``), and every BN in train mode the global batch's
statistics.  A batch split over devices inside one process passes the whole
batch's max as ``batch_max`` instead (the mesh ``Recognizer``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from ctc_pytorch_tpu_torch.config import PORT_ONLY_DEFAULTS, CNNConfig, Config
from ctc_pytorch_tpu_torch.models.cnn import CNNStack
from ctc_pytorch_tpu_torch.models.layers import BatchNorm, Linear
from ctc_pytorch_tpu_torch.models.rnn import RNNStack
from ctc_pytorch_tpu_torch.parallel.mesh import DataGroup, all_max


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Everything needed to rebuild the model (checkpoint contract)."""

    add_cnn: bool
    cnn: CNNConfig
    rnn_input_size: int
    rnn_hidden_size: int
    rnn_layers: int
    rnn_cell: str  # lstm | gru | rnn
    bidirectional: bool
    batch_norm: bool
    num_class: int
    drop_out: float
    compute_dtype: str = "bfloat16"
    use_pallas_rnn: bool = False  # JAX package knob, kept for the manifest
    remat: bool = False  # recompute each RNN layer in the backward pass
    # 'batchmax' | 'padded' | 'valid': what the padding region does to BN
    # (see ctc_pytorch_tpu/models/ctc_model.py:54-67 and config.py)
    pad_dynamics: str = "batchmax"
    # 'concat' | 'sum': how a layer's two directions join (models/rnn.py)
    rnn_merge: str = "concat"
    # LSTM cells with a bias, packed over the batch's lengths
    rnn_bias: bool = False

    def __post_init__(self):
        if self.pad_dynamics not in ("batchmax", "padded", "valid"):
            raise ValueError(
                f"pad_dynamics must be 'batchmax', 'padded' or 'valid', "
                f"got {self.pad_dynamics!r}"
            )

    @classmethod
    def from_config(cls, cfg: Config, num_class: int) -> "ModelSpec":
        return cls(
            add_cnn=cfg.cnn.add_cnn,
            cnn=cfg.cnn,
            rnn_input_size=cfg.rnn_input_size,
            rnn_hidden_size=cfg.rnn_hidden_size,
            rnn_layers=cfg.rnn_layers,
            rnn_cell=cfg.rnn_cell,
            bidirectional=cfg.bidirectional,
            batch_norm=cfg.batch_norm,
            num_class=num_class,
            drop_out=cfg.drop_out,
            compute_dtype=cfg.dtype,
            use_pallas_rnn=cfg.use_pallas_rnn,
            remat=cfg.remat,
            pad_dynamics=(
                "valid" if (cfg.bn_mask_padding
                            and cfg.pad_dynamics == "batchmax")
                else cfg.pad_dynamics
            ),
            rnn_merge=cfg.rnn_merge,
            rnn_bias=bool(cfg.rnn_bias),
        )

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["cnn"] = dataclasses.asdict(self.cnn)
        for key, default in PORT_ONLY_DEFAULTS.items():
            if d[key] == default:
                del d[key]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ModelSpec":
        d = dict(d)
        # pre-round-5 checkpoints carry bn_mask_padding instead of
        # pad_dynamics; rebuild them with their original training dynamics
        if "pad_dynamics" not in d:
            d["pad_dynamics"] = (
                "valid" if d.pop("bn_mask_padding", False) else "padded"
            )
        else:
            d.pop("bn_mask_padding", None)
        cnn = d.pop("cnn")
        for pk in ("channel", "kernel_size", "stride", "padding"):
            cnn[pk] = [tuple(p) for p in cnn[pk]]
        if cnn.get("pooling"):
            # entries are PER LAYER and may be None for unpooled layers
            cnn["pooling"] = [
                tuple(p) if p is not None else None for p in cnn["pooling"]
            ]
        return cls(cnn=CNNConfig(**cnn), **d)

    @property
    def rnn_in_after_cnn(self) -> int:
        """Post-CNN feature size: freq' * out_channels (``model_ctc.py:111,116``)."""
        if not self.add_cnn:
            return self.rnn_input_size
        f = self.cnn.output_freq_len(self.rnn_input_size)
        return f * self.cnn.channel[-1][1]

    @property
    def dirs(self) -> int:
        return 2 if self.bidirectional else 1

    @property
    def rnn_out(self) -> int:
        """Features out of a recurrent layer: H with summed directions,
        else ``dirs`` * H."""
        return self.rnn_hidden_size * (1 if self.rnn_merge == "sum"
                                       else self.dirs)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def output_time_len(self, t):
        """Frames out of the model for ``t`` frames in (an int or an int
        tensor) -- rescales the fractional ``input_sizes`` contract."""
        return self.cnn.output_time_len(t) if self.add_cnn else t


class CTCModel(nn.Module):
    @staticmethod
    def batch_max_frames(
        frac: torch.Tensor, t_in: int, example_mask: Optional[torch.Tensor] = None,
        group: Optional[DataGroup] = None,
        batch_max: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """True per-utterance input frames and the batch max (0-d), with the
        float32 ops of ``ctc_model.py:146-167``: ``round`` is half-to-even like
        ``jnp.round``.  Repeat-padded rows are excluded from the max, which
        is taken over ``group`` where given; ``batch_max`` replaces it."""
        true_in = torch.round(frac * t_in).to(torch.int32)
        if batch_max is not None:
            return true_in, batch_max
        rows = true_in if example_mask is None else torch.where(
            example_mask > 0, true_in, torch.zeros_like(true_in))
        return true_in, all_max(torch.clamp(rows.max(), min=1), group)

    @staticmethod
    def input_sizes(spec: ModelSpec, frac: torch.Tensor, t_in: int, t_out: int,
                    example_mask: Optional[torch.Tensor] = None,
                    group: Optional[DataGroup] = None,
                    batch_max: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Valid output frames for the decode (``train_ctc.py:46``), in the same
        float32 ops as ``ctc_model.py:170-193``, truncation included."""
        if spec.pad_dynamics != "batchmax":
            return (frac * t_out).to(torch.int32)
        true_in, bmax = CTCModel.batch_max_frames(frac, t_in, example_mask,
                                                  group, batch_max)
        t_out_b = spec.output_time_len(bmax)
        q = true_in.to(torch.float32) / bmax.to(torch.float32)
        return (q * t_out_b.to(torch.float32)).to(torch.int32)

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = spec
        self.cnn = CNNStack(spec.cnn) if spec.add_cnn else None
        self.rnns = RNNStack(
            cell=spec.rnn_cell, input_size=spec.rnn_in_after_cnn,
            hidden_size=spec.rnn_hidden_size, num_layers=spec.rnn_layers,
            bidirectional=spec.bidirectional, batch_norm=spec.batch_norm,
            merge=spec.rnn_merge, bias=spec.rnn_bias,
        )
        fc_in = spec.rnn_out
        self.fc_bn = BatchNorm(fc_in) if spec.batch_norm else None
        self.fc = Linear(fc_in, spec.num_class)
        self.eval()  # built in eval mode; train mode is asked for explicitly

    def reset_parameters(self, gen: torch.Generator) -> None:
        """torch's default inits (the JAX package's ``CTCModel.init``
        distributions), drawn from ``gen``; BN starts at identity."""
        for layer in self.cnn or ():
            layer.reset_parameters(gen)
        for layer in self.rnns:
            for direction in layer.directions:
                direction.reset_parameters(gen)
        bound = 1.0 / math.sqrt(self.fc.w.shape[0])
        with torch.no_grad():
            self.fc.w.uniform_(-bound, bound, generator=gen)

    def forward(self, x: torch.Tensor, frac: Optional[torch.Tensor] = None,
                example_mask: Optional[torch.Tensor] = None,
                train: Optional[bool] = None,
                generator: Optional[torch.Generator] = None,
                lengths: Optional[torch.Tensor] = None,
                visualize: bool = False, group: Optional[DataGroup] = None,
                batch_max: Optional[torch.Tensor] = None):
        """(B, T, F) -> log_probs (T', B, num_class).

        ``frac``: the collate's ``len / T_pad`` per row; drives the
        padding-masked BN planes of the 'batchmax' and 'valid' packages
        (a no-op for 'padded').  ``example_mask``: (B,) 0/1 validity of
        batch rows; repeat-padded rows drop out of the batchmax BN mask.

        ``train``: sets the module's mode for this and later calls (None
        keeps it).  In train mode every BN normalises with batch statistics
        and updates its running buffers in place, the recurrent layers run the
        trainable kernels, and dropout at ``spec.drop_out`` is drawn from
        ``generator`` (on ``x``'s device; required when ``spec.drop_out > 0``).
        With ``spec.remat`` each recurrent layer is recomputed in the
        backward pass instead of keeping its activations
        (``models/rnn.py``).

        ``lengths``: (B,) valid frames at the recurrent layers' input, for
        packed-sequence semantics there (``models/rnn.py``).  A model with
        ``rnn_bias`` takes them from ``frac`` where they are not given: the
        output lengths of ``input_sizes``.

        ``group``: the data-parallel group of a rank's share of a global
        batch: the batch max and the train-mode BN statistics are the global
        batch's.  ``batch_max``: the max input frames to use instead of this
        batch's own (a shard of a batch split inside one process).

        ``visualize``: also return the activations the reference shows
        (``visualize.py:107-132``), as the JAX ``CTCModel.apply(visualize=
        True)`` returns them: ``(log_probs, [x, post-CNN (B, C, T', F')
        fp32, pre-RNN (T', B, C*F'), log_probs])``, the two CNN planes only
        with a CNN."""
        if train is not None:
            self.train(train)
        spec = self.spec
        drop = spec.drop_out if self.training else 0.0
        cd = spec.torch_dtype
        bmax = None
        if frac is not None and spec.pad_dynamics == "batchmax":
            _, bmax = CTCModel.batch_max_frames(frac, x.shape[1], example_mask,
                                                group, batch_max)

        visual = [x] if visualize else None
        if self.cnn is not None:
            out = self.cnn(x[:, None], cd, t_valid=bmax,
                           example_mask=example_mask, drop_rate=drop,
                           generator=generator, group=group)  # (B, C, T', F')
            if visualize:
                visual.append(out.float())
            b, c, t, f = out.shape
            # (B, C, T', F') -> (T', B, C*F'): C-major features, the
            # reference's reshape (model_ctc.py:153-158)
            out = out.permute(2, 0, 1, 3).reshape(t, b, c * f)
            if visualize:
                visual.append(out)
        else:
            out = x.transpose(0, 1)

        bn_mask = None
        t_rnn, b = out.shape[0], out.shape[1]
        t_idx = torch.arange(t_rnn, device=out.device)
        if spec.pad_dynamics == "valid" and frac is not None:
            valid = (frac * t_rnn).to(torch.int32)
            bn_mask = (t_idx[:, None] < valid[None, :]).float()
        elif bmax is not None:
            t_cut = spec.output_time_len(bmax)
            bn_mask = (t_idx[:, None] < t_cut).expand(t_rnn, b)
            if example_mask is not None:
                bn_mask = bn_mask & (example_mask > 0)[None, :]
            bn_mask = bn_mask.float()

        if lengths is None and spec.rnn_bias and frac is not None:
            # biased cells are packed: each utterance's recurrence spans the
            # frames its CTC loss reads
            lengths = CTCModel.input_sizes(spec, frac, x.shape[1], t_rnn,
                                           batch_max=bmax)
        out = self.rnns(out, cd, bn_mask, lengths=lengths, drop_rate=drop,
                        generator=generator, group=group, remat=spec.remat)
        t, b, h = out.shape
        flat = out.reshape(t * b, h)
        if self.fc_bn is not None:
            flat = self.fc_bn(flat, bn_mask, group)
        logits = self.fc(flat, cd).reshape(t, b, -1)
        log_probs = torch.log_softmax(logits, dim=-1)
        if visualize:
            return log_probs, visual + [log_probs]
        return log_probs

    def add_weights_noise(self, stddev: float = 0.075,
                          generator: Optional[torch.Generator] = None) -> None:
        """Gaussian weight noise on every parameter, in place
        (``model_ctc.py:204-207``; the JAX ``CTCModel.add_weights_noise``).
        BN running statistics are buffers and stay as they are.  The noise is
        drawn from ``generator``, which must live on the parameters' device;
        its stream is not the JAX package's."""
        with torch.no_grad():
            for p in self.parameters():
                p.add_(torch.randn(p.shape, generator=generator,
                                   device=p.device, dtype=p.dtype),
                       alpha=stddev)
