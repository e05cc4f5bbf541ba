"""Recognition API: a checkpoint package in, transcripts out.

Counterpart of ``ctc_pytorch_tpu/api.py``, the serving surface: load a
trained package once (either package's ``.npz``), then ``recognize(path or
samples)`` runs frontend -> model -> decode, batched, on ``device`` (default
``cuda``; raises without a card).  The frontend is ``frontend/e2e.py``'s
with the training-time CMVN stats; decoding is greedy on the device or the
host prefix beam search with the bigram LM (``decode/beam.py``).  TF32 is
off, as in the CLIs, so that the frontend's mel and DCT products and an fp32
model run in fp32.  ``StreamingRecognizer`` decodes a stream in windows
over a ``Recognizer``.

``mesh`` (a list of devices, ``parallel/mesh.py:make_mesh``) serves each
batch split over those devices, one model replica a device, inside one
process (the JAX ``Recognizer(mesh=...)``): the batch is padded to a
multiple of the mesh by repeating its first row, each device runs the
frontend and the model on its rows, and the outputs are gathered on the
first device.  Under the batchmax pad dynamics every shard takes the whole
batch's max input length, so the strings are the single-device
``Recognizer``'s.  The JAX mesh ``Recognizer`` takes each shard's own max
(``ctc_pytorch_tpu/api.py:71-80``), so its strings can differ from its
single-device ones where the shards' maxima differ.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ctc_pytorch_tpu_torch import resolve_device
from ctc_pytorch_tpu_torch.data.prep.sphere import read_audio
from ctc_pytorch_tpu_torch.decode import BeamDecoder, GreedyDecoder
from ctc_pytorch_tpu_torch.frontend.e2e import WaveFrontendSpec, build_frontend_fn
from ctc_pytorch_tpu_torch.models.ctc_model import CTCModel
from ctc_pytorch_tpu_torch.parallel.mesh import (
    make_mesh,
    pad_batch_to_devices,
    shard_batch,
)
from ctc_pytorch_tpu_torch.train.checkpoint import model_from_package
from ctc_pytorch_tpu_torch.vocab import Vocab

AudioInput = Union[str, Path, np.ndarray]


class Recognizer:
    def __init__(
        self,
        package_path: str | Path,
        vocab: Vocab,
        *,
        frontend: Optional[WaveFrontendSpec] = None,
        cmvn: Optional[tuple] = None,
        decode_type: str = "Greedy",
        beam_width: int = 10,
        lm_path: Optional[str] = None,
        lm_alpha: float = 0.1,
        mesh=None,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.vocab = vocab
        self.spec, self.model, self.manifest = model_from_package(
            package_path, self.device)
        self.mesh = None if mesh is None else make_mesh(mesh)
        # one replica a device of the mesh
        self.replicas = {d: (self.model if d == self.device else
                             model_from_package(package_path, d)[1])
                         for d in self.mesh or ()}
        self.frontend = frontend or WaveFrontendSpec()
        self.cmvn = cmvn
        self._frontend_fn = build_frontend_fn(self.frontend, cmvn)
        if decode_type == "Greedy":
            self.decoder = GreedyDecoder(vocab.index2word)
        else:
            self.decoder = BeamDecoder(
                vocab.index2word, beam_width=beam_width, lm_path=lm_path,
                lm_alpha=lm_alpha,
            )

    @torch.inference_mode()
    def _forward(self, wavs: torch.Tensor, wav_lengths: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, S) samples and (B,) sample counts on the device ->
        ((T', B, C) log-probs, (B,) valid output frames); with a mesh, the
        rows split over its devices and the outputs on the first."""
        if self.mesh is None:
            feats, frac, _ = self._frontend_fn(wavs, wav_lengths)
            log_probs = self.model(feats, frac=frac)
            return log_probs, CTCModel.input_sizes(
                self.spec, frac, feats.shape[1], log_probs.shape[0])
        b = wavs.shape[0]
        bp = pad_batch_to_devices(b, len(self.mesh))
        if bp != b:  # repeated rows, sliced off below
            wavs = torch.cat([wavs, wavs[:1].expand(bp - b, -1)])
            wav_lengths = torch.cat([wav_lengths,
                                     wav_lengths[:1].expand(bp - b)])
        shards = [self._frontend_fn(w, n)[:2]
                  for w, n in shard_batch((wavs, wav_lengths), self.mesh)]
        home = self.mesh[0]
        # the whole batch's max input frames, for every shard
        bmax = torch.stack([
            CTCModel.batch_max_frames(frac, feats.shape[1])[1].to(home)
            for feats, frac in shards]).max()
        log_probs, sizes = [], []
        for dev, (feats, frac) in zip(self.mesh, shards):
            bm = bmax.to(dev)
            lp = self.replicas[dev](feats, frac=frac, batch_max=bm)
            sizes.append(CTCModel.input_sizes(
                self.spec, frac, feats.shape[1], lp.shape[0],
                batch_max=bm).to(home))
            log_probs.append(lp.to(home))
        return torch.cat(log_probs, 1)[:, :b], torch.cat(sizes)[:b]

    def _load(self, item: AudioInput) -> np.ndarray:
        if isinstance(item, (str, Path)):
            return read_audio(item)
        return np.asarray(item, np.float32)

    def recognize(self, audio: Union[AudioInput, Sequence[AudioInput]],
                  pad_multiple: int = 16000) -> List[str]:
        """One utterance or a batch; returns the decoded unit strings."""
        items = ([audio] if isinstance(audio, (str, Path, np.ndarray))
                 else list(audio))
        wavs = [self._load(i) for i in items]
        lengths = np.asarray([len(w) for w in wavs], np.int32)
        s_max = ((int(lengths.max()) + pad_multiple - 1) // pad_multiple
                 ) * pad_multiple
        batch = np.zeros((len(wavs), s_max), np.float32)
        for i, w in enumerate(wavs):
            batch[i, : len(w)] = w
        log_probs, sizes = self._forward(
            torch.from_numpy(batch).to(self.device),
            torch.from_numpy(lengths).to(self.device))
        return [s.strip() for s in self.decoder.decode(log_probs, sizes)]


class StreamingRecognizer:
    """Chunked decoding of a stream over a (bidirectional) ``Recognizer``.

    The reference model family is bidirectional (``rnn_type nn.LSTM,
    bidirectional True``, ``timit/conf/ctc_config.yaml:26-27``), so exact
    frame-synchronous streaming is impossible; as in the JAX package, audio
    accumulates in a ring buffer and every ``hop_seconds`` of new audio the
    model decodes the last ``window_seconds`` again.  Tokens whose frames are
    older than the lookahead margin are **committed** (never retracted); the
    tail stays provisional until ``finish()``.  Windows are padded to
    power-of-two sample counts, so a stream meets few shapes.
    """

    def __init__(self, recognizer: Recognizer, *, window_seconds: float = 10.0,
                 hop_seconds: float = 0.5, lookahead_seconds: float = 0.4,
                 sample_rate: int = 16000):
        self.rec = recognizer
        self.sr = sample_rate
        self.window = int(window_seconds * sample_rate)
        self.hop = int(hop_seconds * sample_rate)
        self.lookahead = lookahead_seconds
        self._buf = np.zeros(0, np.float32)
        self._buf_start = 0  # absolute sample index of _buf[0]
        self._since_decode = 0
        self._committed: List[str] = []
        # absolute sample position of the last committed token's frame
        # centre; every window's tokens are mapped to absolute positions so
        # that commits stay right after audio slides out of the window
        self._committed_pos = -1.0
        self._provisional: List[str] = []

    def _decode_window(self, final: bool) -> None:
        wav = (self._buf[-self.window:] if len(self._buf) > self.window
               else self._buf)
        if len(wav) < self.sr // 50:  # <20 ms: nothing decodable yet
            return
        abs0 = self._buf_start + (len(self._buf) - len(wav))
        n = 1 << max(int(np.ceil(np.log2(len(wav)))), 12)
        batch = np.zeros((1, n), np.float32)
        batch[0, : len(wav)] = wav
        dev = self.rec.device
        log_probs, sizes = self.rec._forward(
            torch.from_numpy(batch).to(dev),
            torch.full((1,), len(wav), dtype=torch.int32, device=dev))
        lp = log_probs[:, 0, :].float().cpu().numpy()
        t_valid = int(sizes[0])
        hyp_tokens, frame_idx = self._greedy_with_frames(lp, t_valid)
        spf = len(wav) / max(t_valid, 1)  # samples per output frame
        pos = [abs0 + (fi + 0.5) * spf for fi in frame_idx]
        if final and self._buf_start == 0 and len(self._buf) <= self.window:
            # nothing ever slid out of the window: the fresh hypothesis
            # covers the whole stream and supersedes the running state
            self._committed = hyp_tokens
            self._committed_pos = pos[-1] if pos else -1.0
            self._provisional = []
            return
        # tokens strictly after the committed span; a same-label token
        # within ~1.5 frames of the last commit is a re-detection (frame
        # positions jitter by a frame or so between overlapping decodes)
        fresh = []
        for tok, p in zip(hyp_tokens, pos):
            if p <= self._committed_pos:
                continue
            if (not fresh and self._committed
                    and tok == self._committed[-1]
                    and p - self._committed_pos < 1.5 * spf):
                continue
            fresh.append((tok, p))
        if final:
            self._committed += [t for t, _ in fresh]
            if fresh:
                self._committed_pos = fresh[-1][1]
            self._provisional = []
            return
        # commit the tokens older than the lookahead margin (an absolute
        # horizon)
        horizon = abs0 + len(wav) - self.lookahead * self.sr
        stable = [(t, p) for t, p in fresh if p < horizon]
        self._committed += [t for t, _ in stable]
        if stable:
            self._committed_pos = stable[-1][1]
        self._provisional = [t for t, _ in fresh[len(stable):]]
        # bound host memory: only the last window is ever decoded again
        if len(self._buf) > self.window:
            cut = len(self._buf) - self.window
            self._buf = self._buf[cut:]
            self._buf_start += cut

    def _greedy_with_frames(self, lp_tc: np.ndarray, t_valid: int):
        """Greedy collapse keeping each emitted token's frame index."""
        ids = np.argmax(lp_tc[:t_valid], axis=-1)
        toks, frames = [], []
        prev = 0
        for i, c in enumerate(ids):
            if c != 0 and c != prev:
                toks.append(self.rec.vocab.index2word.get(int(c), "<UNK>"))
                frames.append(i)
            prev = int(c)
        return toks, frames

    def feed(self, samples: np.ndarray) -> str:
        """Append audio; returns the current hypothesis (committed + tail)."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._buf = np.concatenate([self._buf, samples])
        self._since_decode += len(samples)
        if self._since_decode >= self.hop:
            self._since_decode = 0
            self._decode_window(final=False)
        return " ".join(self._committed + self._provisional).strip()

    def finish(self) -> str:
        """Flush: decode everything buffered and return the final text."""
        self._decode_window(final=True)
        out = " ".join(self._committed).strip()
        self._buf = np.zeros(0, np.float32)
        self._buf_start = 0
        self._committed, self._provisional = [], []
        self._committed_pos = -1.0
        self._since_decode = 0
        return out
