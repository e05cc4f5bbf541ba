"""The port's audio frontend (``ctc_pytorch_tpu_torch/frontend/``) against
the JAX package's on the CPU: every public function of ``features.py``,
``cmvn.py``, ``splice.py`` and ``fmel.py`` on seeded inputs, and the five
signals x five feature sets of ``tests/fixtures/frontend_golden.npz``.

Tolerance atol 3e-4, rtol 1e-5 on log-scale features (the fixture test's,
``tests/test_frontend_fixture.py``): the same fp32 math through another FFT
and another summation order.  Where a feature is set by fp32 rounding and
not by its input, no other implementation can reproduce it: the fixture's
mel energies below 1e-8 of their frame's spectral power (the far bins of the
povey-window tone and chirp, whose true energy lies under the fp32 FFT's
noise floor, and the silent frames of ``dc_step``, where XLA's fused
arithmetic leaves a residual that the unfused ops do not), every cepstrum
of a frame that holds such a bin, and the STFT bins below the same floor.
A float64 numpy pipeline finds those entries.  Everywhere else the stated
tolerance holds; below the floor the log-mel and STFT entries of both must
lie near it, and every cepstrum must differ from the fixture's by just the
DCT of the two log-mel differences.  Each case holds a stated share of its
entries, or is named as one that holds none."""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctc_pytorch_tpu.frontend import cmvn as jcmvn
from ctc_pytorch_tpu.frontend import features as J
from ctc_pytorch_tpu.frontend import fmel as jfmel
from ctc_pytorch_tpu.frontend import splice as jsplice
from ctc_pytorch_tpu_torch.frontend import cmvn, features as P, fmel, splice
from tools.gen_frontend_fixture import configs, waves

FIXTURE = Path(__file__).parent / "fixtures" / "frontend_golden.npz"
TOL = dict(rtol=1e-5, atol=3e-4)
FLOOR = 1e-8  # of the frame's spectral power: the fp32 FFT's noise floor


def port_cfg(cfg) -> P.FrontendConfig:
    return P.FrontendConfig(**dataclasses.asdict(cfg))


def signals(b=2, s=6000, seed=0) -> np.ndarray:
    """Speech-like batch: harmonics under an envelope plus noise, int16
    range, so every mel band sits far above the fp32 noise floor."""
    rng = np.random.RandomState(seed)
    t = np.arange(s) / 16000.0
    out = []
    for _ in range(b):
        f0 = rng.uniform(90, 250)
        x = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6))
                / k for k in range(1, 12))
        x = x * (1 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t))
        out.append((x + 0.3 * rng.randn(s)) * 3000)
    return np.stack(out).astype(np.float32)


def close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def close_log_power(got: torch.Tensor, want):
    """Log power spectra: the stated tolerance on bins within 1e-6 of their
    frame's largest; in the notches below, where fp32 rounding of the FFT
    is a large part of a bin, the powers within 1e-6 of that largest."""
    got, want = got.numpy(), np.asarray(want)
    top = want.max(-1, keepdims=True)
    deep = want < top + np.log(1e-6)
    np.testing.assert_allclose(got[~deep], want[~deep], **TOL)
    scale = np.broadcast_to(np.exp(top), want.shape)[deep]
    np.testing.assert_allclose(np.exp(got[deep]) / scale,
                               np.exp(want[deep]) / scale, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the frozen fixture
# ---------------------------------------------------------------------------

def _frames64(wav: np.ndarray, cfg):
    flen, shift = cfg.frame_length, cfg.frame_shift
    t = 1 + (len(wav) - flen) // shift
    return np.stack([wav[i * shift:i * shift + flen]
                     for i in range(t)]).astype(np.float64)


def _power64(wav: np.ndarray, cfg):
    """Kaldi's power spectrum in float64 (an independent numpy pipeline)
    and each frame's scale: the larger of its spectral power and ``nfft``
    times its raw energy (DC removal in fp32 leaves residuals of the raw
    samples' size)."""
    raw = _frames64(wav, cfg)
    x = raw - raw.mean(-1, keepdims=True)
    y = x.copy()
    y[:, 1:] = x[:, 1:] - cfg.preemph * x[:, :-1]
    y[:, 0] = x[:, 0] - cfg.preemph * x[:, 0]
    y = y * J._window_coeffs(cfg).astype(np.float64)
    pw = np.abs(np.fft.rfft(y, n=cfg.fft_size)) ** 2
    scale = np.maximum(pw.sum(-1), cfg.fft_size * (raw ** 2).sum(-1))
    return pw, scale[:, None]


def _stft64(wav: np.ndarray) -> np.ndarray:
    """``log_spectrum_librosa``'s STFT power in float64: centred,
    reflect-padded, hamming window."""
    pad = np.pad(wav.astype(np.float64), (200, 200), mode="reflect")
    t = 1 + (len(pad) - 400) // 160
    fr = np.stack([pad[i * 160:i * 160 + 400] for i in range(t)])
    return np.abs(np.fft.rfft(fr * np.hamming(400))) ** 2


def _held(kind: str, cfg, wav: np.ndarray, shape) -> np.ndarray:
    """True where a fixture entry is set by its input: the float64 mel
    energy (or STFT power) is at least FLOOR of its frame's scale."""
    if kind == "spectrum":
        pw = _stft64(wav)
        return pw >= FLOOR * pw.sum(-1, keepdims=True)
    n_mels = cfg.num_mel_bins if kind == "fbank" else 23
    pw, scale = _power64(wav, cfg)
    mel = pw @ J.mel_filterbank(dataclasses.replace(
        cfg, num_mel_bins=n_mels)).astype(np.float64)
    ok = mel >= FLOOR * scale
    if kind == "fbank":
        energy = np.ones((ok.shape[0], int(cfg.use_energy)), bool)
        return np.concatenate([energy, ok], axis=-1)
    frame_ok = ok.all(-1)
    if kind == "mfcc_deltas":  # deltas read frames within +-4
        shifted = [np.roll(np.pad(frame_ok, 4, constant_values=True), k)[4:-4]
                   for k in range(-4, 5)]
        frame_ok = np.logical_and.reduce(shifted)
    return np.broadcast_to(frame_ok[:, None], shape)


def _port_features(kind: str, cfg, wav: np.ndarray) -> torch.Tensor:
    x = torch.from_numpy(wav)
    if kind == "fbank":
        return P.fbank(x, port_cfg(cfg))
    if kind == "mfcc":
        return P.mfcc(x, port_cfg(cfg))
    if kind == "mfcc_deltas":
        return P.add_deltas(P.mfcc(x, port_cfg(cfg)))
    return P.log_spectrum_librosa(x)


def _hold_log_mel(got, want, cfg, wav, what):
    """Log-mel features: entries held by their input within TOL; below the
    floor both sit near it, with no mel energy above 1e-6 of the frame's
    scale (the floor is 1e-8)."""
    held = _held("fbank", cfg, wav, want.shape)
    np.testing.assert_allclose(got[held], want[held], **TOL, err_msg=what)
    scale = np.broadcast_to(_power64(wav, cfg)[1], want.shape)
    cap = np.log(np.maximum(1e-6 * scale, P.EPS))
    assert (got[~held] <= cap[~held]).all(), what
    assert (want[~held] <= cap[~held]).all(), what


def _hold_cepstra(kind, cfg, wav, got, want, what):
    """Every cepstrum: the port's and the fixture's differ by the DCT (and
    deltas) of the difference of their 23 log-mel energies, within TOL, and
    those log-mel energies are held as fbank features are.  So a cepstrum
    that no implementation can reproduce is off only by its sub-floor
    bins, each bounded by the floor cap."""
    mel_cfg = dataclasses.replace(cfg, num_mel_bins=23, use_energy=False)
    port_mel = P.fbank(torch.from_numpy(wav), port_cfg(mel_cfg)).numpy()
    jax_mel = np.asarray(J.fbank(jnp.asarray(wav), mel_cfg))
    _hold_log_mel(port_mel, jax_mel, mel_cfg, wav, what + " log-mel")
    dct = P.dct_matrix(23, cfg.num_ceps).astype(np.float64)
    shift = (port_mel.astype(np.float64) - jax_mel) @ dct.T
    shift = torch.from_numpy(shift * P._lifter_coeffs(port_cfg(cfg)))
    if kind == "mfcc_deltas":
        shift = P.add_deltas(shift)
    np.testing.assert_allclose(got, want + shift.numpy(), **TOL, err_msg=what)


def _hold_spectrum_floor(got, want, held, wav, what):
    """Normalised log1p(|STFT|) below the floor: both at most the value of
    a bin with 1e-6 of its frame's power, in the float64 pipeline's
    normalisation."""
    pw = _stft64(wav)
    feats = np.log1p(np.sqrt(pw))
    mean, std = feats.mean(), feats.std()
    cap = (np.log1p(np.sqrt(1e-6 * pw.sum(-1, keepdims=True))) - mean) / std
    cap = np.broadcast_to(cap, want.shape)
    assert (got[~held] <= cap[~held]).all(), what
    assert (want[~held] <= cap[~held]).all(), what


# cases in which every entry is under the floor rule: each frame of the
# povey-window tone and chirp holds a far mel bin below it, and deltas
# spread the silent frames of dc_step over all others.  Every other case
# holds at least MIN_HELD of its entries.
ALL_UNHELD = {("mfcc13", "tone"), ("mfcc13", "chirp"),
              ("mfcc39_deltas", "tone"), ("mfcc39_deltas", "chirp"),
              ("mfcc39_deltas", "dc_step")}
MIN_HELD = 0.05


@pytest.mark.parametrize("wname", sorted(waves()))
@pytest.mark.parametrize("cname", sorted(configs()))
def test_port_matches_the_frozen_fixture(cname, wname):
    kind, cfg = configs()[cname]
    wav = waves()[wname]
    what = f"{wname}/{cname}"
    with np.load(FIXTURE) as z:
        want = z[what]
    got = _port_features(kind, cfg, wav).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    held = _held(kind, cfg, wav, want.shape)
    if (cname, wname) in ALL_UNHELD:
        assert not held.any(), f"{what} holds entries: take it off ALL_UNHELD"
    else:
        assert held.mean() >= MIN_HELD, f"{what}: {held.mean():.3f} held"
    np.testing.assert_allclose(got[held], want[held], **TOL, err_msg=what)
    if kind == "fbank":
        _hold_log_mel(got, want, cfg, wav, what)
    elif kind == "spectrum":
        _hold_spectrum_floor(got, want, held, wav, what)
    else:
        _hold_cepstra(kind, cfg, wav, got, want, what)
    if wname == "noise":  # broadband: every entry above the floor
        assert held.all()


# ---------------------------------------------------------------------------
# features.py, function by function, against the JAX package
# ---------------------------------------------------------------------------

FBANK_CFGS = [
    P.FrontendConfig(num_mel_bins=23),
    P.FrontendConfig(num_mel_bins=12, window="povey", use_energy=False),
    P.FrontendConfig(num_mel_bins=16, window="hanning", raw_energy=False),
    P.FrontendConfig(num_mel_bins=20, window="blackman", use_power=False),
    P.FrontendConfig(num_mel_bins=12, window="rectangular",
                     use_log_fbank=False, preemph=0.0, remove_dc=False),
    P.FrontendConfig(num_mel_bins=15, low_freq=64.0, high_freq=-400.0,
                     round_to_power_of_two=False),
]


def jax_cfg(cfg: P.FrontendConfig) -> J.FrontendConfig:
    return J.FrontendConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("cfg", FBANK_CFGS)
def test_fbank_and_its_parts_match_jax(cfg):
    wav = signals()
    jc = jax_cfg(cfg)
    np.testing.assert_array_equal(P._window_coeffs(cfg), J._window_coeffs(jc))
    np.testing.assert_array_equal(P.mel_filterbank(cfg), J.mel_filterbank(jc))
    np.testing.assert_array_equal(
        P.frame_signal(torch.from_numpy(wav), cfg).numpy(),
        np.asarray(J.frame_signal(jnp.asarray(wav), jc)))
    power, log_e = P.power_spectrum(torch.from_numpy(wav), cfg)
    jpower, jlog_e = J.power_spectrum(jnp.asarray(wav), jc)
    # the power's own scale: fp32 relative to the frame's largest bin
    scale = np.asarray(jpower).max(-1, keepdims=True)
    np.testing.assert_allclose(power.numpy() / scale,
                               np.asarray(jpower) / scale, rtol=0, atol=1e-6)
    close(log_e, jlog_e)
    close(P.fbank(torch.from_numpy(wav), cfg),
          J.fbank(jnp.asarray(wav), jc),
          **(TOL if cfg.use_log_fbank else dict(rtol=1e-5, atol=1e-2)))


@pytest.mark.parametrize("cfg", [
    P.FrontendConfig(), P.FrontendConfig(window="povey", mfcc_use_energy=True),
    P.FrontendConfig(num_ceps=20, cepstral_lifter=0.0)])
def test_mfcc_spectrogram_and_deltas_match_jax(cfg):
    wav = signals(seed=1)
    jc = jax_cfg(cfg)
    x, jx = torch.from_numpy(wav), jnp.asarray(wav)
    np.testing.assert_array_equal(P.dct_matrix(23, cfg.num_ceps),
                                  J.dct_matrix(23, cfg.num_ceps))
    np.testing.assert_array_equal(P._lifter_coeffs(cfg), J._lifter_coeffs(jc))
    for n_mels in (23, 17):
        close(P.mfcc(x, cfg, n_mels), J.mfcc(jx, jc, n_mels))
    close(P.add_deltas(P.mfcc(x, cfg)), J.add_deltas(J.mfcc(jx, jc)))
    close(P.add_deltas(P.mfcc(x, cfg), order=1, window=3),
          J.add_deltas(J.mfcc(jx, jc), order=1, window=3))
    close_log_power(P.spectrogram(x, cfg), J.spectrogram(jx, jc))


@pytest.mark.parametrize("normalize", [True, False])
def test_log_spectrum_librosa_matches_jax(normalize):
    wav = signals(s=5000, seed=2)
    for n_fft, hop in ((400, 160), (256, 100)):
        close(P.log_spectrum_librosa(torch.from_numpy(wav), n_fft, hop,
                                     normalize),
              J.log_spectrum_librosa(jnp.asarray(wav), n_fft, hop, normalize))


def test_num_frames_and_short_input_match_jax():
    cfg = P.FrontendConfig()
    lens = np.array([0, 399, 400, 401, 559, 560, 16000], np.int32)
    got = P.num_frames(torch.from_numpy(lens), cfg.frame_length,
                       cfg.frame_shift)
    want = np.asarray(J.num_frames(jnp.asarray(lens), 400, 160))
    np.testing.assert_array_equal(got.numpy(), want)
    assert [P.num_frames(int(n), 400, 160) for n in lens] == want.tolist()
    short = torch.zeros(2, 300)
    assert P.frame_signal(short, cfg).shape == (2, 0, 400)
    assert P.fbank(short, cfg).shape == (2, 0, 81)


def test_dither_is_seeded_by_content():
    """Deterministic for a seed and content, different between utterances
    and between seeds, and about the asked size."""
    cfg = P.FrontendConfig(dither=1.0, dither_seed=3)
    zero = torch.zeros(6000)
    a = P.fbank(zero, cfg)
    assert torch.equal(a, P.fbank(zero, cfg))
    assert not torch.equal(a, P.fbank(zero + 1.0, cfg))
    assert not torch.equal(a, P.fbank(zero, dataclasses.replace(
        cfg, dither_seed=4)))
    frames = P.frame_signal(zero, cfg)
    x, _ = P._preprocess_frames(frames, dataclasses.replace(
        cfg, remove_dc=False, preemph=0.0), torch.ones(400))
    assert 0.9 < float(x.std()) < 1.1


# ---------------------------------------------------------------------------
# cmvn.py, splice.py, fmel.py
# ---------------------------------------------------------------------------

def test_cmvn_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    feats = (rng.randn(3, 20, 7) * 3 + 5).astype(np.float32)
    mask = (np.arange(20)[None] < np.array([20, 13, 4])[:, None])
    stats = cmvn.init_cmvn(7)
    jstats = jcmvn.init_cmvn(7)
    for m in (None, mask):
        stats = cmvn.accumulate_cmvn(
            stats, torch.from_numpy(feats),
            None if m is None else torch.from_numpy(m))
        jstats = jcmvn.accumulate_cmvn(
            jstats, jnp.asarray(feats), None if m is None else jnp.asarray(m))
    assert float(stats.count) == float(jstats.count) == 60 + 37
    close(stats.sum, jstats.sum, rtol=1e-6)
    close(stats.sumsq, jstats.sumsq, rtol=1e-6)
    mean, inv_std = cmvn.finalize_cmvn(stats)
    jmean, jinv = jcmvn.finalize_cmvn(jstats)
    close(mean, jmean, rtol=1e-5, atol=1e-6)
    close(inv_std, jinv, rtol=1e-5)
    x = torch.from_numpy(feats)
    close(cmvn.apply_cmvn(x, mean, inv_std),
          jcmvn.apply_cmvn(jnp.asarray(feats), jmean, jinv))
    close(cmvn.apply_cmvn(x, mean), jcmvn.apply_cmvn(jnp.asarray(feats), jmean))
    items = [(feats[0], mask[0]), feats[1], feats[:2]]
    for a, b in zip(cmvn.compute_global_cmvn(items, 7),
                    jcmvn.compute_global_cmvn(items, 7)):
        close(a, b, rtol=1e-5, atol=1e-6)
    # the JAX axis_name is the port's group: over a one-rank gloo group the
    # collective sums one share, so the stats are the ungrouped ones (two
    # ranks against JAX's psum: tests/test_torch_parallel.py)
    import torch.distributed as dist

    from ctc_pytorch_tpu_torch.parallel import DataGroup

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        group = DataGroup(None, 0, 1, torch.device("cpu"), "gloo")
        got = cmvn.accumulate_cmvn(stats, x, torch.from_numpy(mask), group)
    finally:
        dist.destroy_process_group()
    want = cmvn.accumulate_cmvn(stats, x, torch.from_numpy(mask))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("left,right,skip,down", [
    (0, 2, 2, 1), (1, 1, 1, 4), (3, 0, 3, 2), (0, 0, 1, 1)])
def test_splice_matches_jax(left, right, skip, down):
    rng = np.random.RandomState(left + 7 * right)
    feats = rng.randn(3, 17, 5).astype(np.float32)
    lens = np.array([17, 9, 1], np.int32)
    x, jx = torch.from_numpy(feats), jnp.asarray(feats)
    close(splice.make_context(x, left, right),
          jsplice.make_context(jx, left, right), rtol=0, atol=0)
    close(splice.make_context(x, left, right, torch.from_numpy(lens)),
          jsplice.make_context(jx, left, right, jnp.asarray(lens)),
          rtol=0, atol=0)
    close(splice.skip_frames(x, skip), jsplice.skip_frames(jx, skip),
          rtol=0, atol=0)
    close(splice.pad_to_downsample(x, down), jsplice.pad_to_downsample(jx, down),
          rtol=0, atol=0)
    for t in (1, 16, 17):
        assert splice.skipped_len(t, skip) == jsplice.skipped_len(t, skip)
        assert splice.downsampled_len(t, down) == jsplice.downsampled_len(t, down)
    for ln in (None, lens):
        got, got_len = splice.splice_and_skip(
            x, None if ln is None else torch.from_numpy(ln), left, right,
            skip, down)
        want, want_len = jsplice.splice_and_skip(
            jx, None if ln is None else jnp.asarray(ln), left, right, skip,
            down)
        close(got, want, rtol=0, atol=0)
        if ln is None:
            assert got_len is None and want_len is None
        else:
            np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


@pytest.mark.parametrize("shape,sr,win", [((11, 201), 16000, 0.025),
                                          ((2, 9, 161), 8000, 0.02)])
def test_f_mel_matches_jax(shape, sr, win):
    spec = np.random.RandomState(0).randn(*shape).astype(np.float32)
    close(fmel.f_mel(torch.from_numpy(spec), sr, win),
          jfmel.f_mel(jnp.asarray(spec), sr, win), rtol=1e-6, atol=1e-6)
