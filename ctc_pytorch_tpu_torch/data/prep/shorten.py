"""Shorten (v1/v2) lossless audio decompression, host-side numpy.

Copy of ``ctc_pytorch_tpu/data/prep/shorten.py``.  LDC SPHERE
distributions ship waveforms as ``embedded-shorten-v*`` payloads, which the
reference pipeline decodes with the sph2pipe C binary
(``timit/local/timit_data_prep.sh:18,52``).  ``decode_shorten`` implements
the shorten bitstream (Tony Robinson's format, the one sph2pipe embeds):

- Rice/Golomb coded unsigned (``uvar``) and signed (``var``) values over an
  MSB-first bitstream padded to 32-bit words;
- block commands DIFF0-3 / QLPC / ZERO / VERBATIM / BLOCKSIZE / BITSHIFT /
  QUIT, with the v2 rounded mean-offset (``nmean``) and ``lpcqoffset``
  semantics;
- sample types S8/U8/S16HL/S16LH/U16HL/U16LH/ULAW/ALAW (u-law/A-law are
  expanded to linear 16-bit exactly like ``sph2pipe -f wav``).

``encode_shorten`` is a minimal v2 encoder (DIFF0-3 block predictors) for
compressed fixtures and round-trip tests; it emits streams any standard
shorten decoder accepts, byte for byte the JAX package's.

I/O, not compute: it stays on the host.
"""

from __future__ import annotations

import numpy as np

MAGIC = b"ajkg"

# --- format constants (shorten 2.x) ---------------------------------------
FNSIZE = 2
ENERGYSIZE = 3
BITSHIFTSIZE = 2
NWRAP = 3
LPCQSIZE = 2
LPCQUANT = 5
XBYTESIZE = 7
CHANSIZE = 0
TYPESIZE = 4
ULONGSIZE = 2
NSKIPSIZE = 1
VERBATIM_CKSIZE_SIZE = 5
VERBATIM_BYTE_SIZE = 8
DEFAULT_BLOCK_SIZE = 256

FN_DIFF0, FN_DIFF1, FN_DIFF2, FN_DIFF3 = 0, 1, 2, 3
FN_QUIT, FN_BLOCKSIZE, FN_BITSHIFT, FN_QLPC = 4, 5, 6, 7
FN_ZERO, FN_VERBATIM = 8, 9

TYPE_AU1, TYPE_S8, TYPE_U8 = 0, 1, 2
TYPE_S16HL, TYPE_U16HL, TYPE_S16LH, TYPE_U16LH = 3, 4, 5, 6
TYPE_ULAW, TYPE_AU2, TYPE_AU3, TYPE_ALAW = 7, 8, 9, 10

_SIGNED_TYPES = {TYPE_S8, TYPE_S16HL, TYPE_S16LH, TYPE_ULAW, TYPE_ALAW,
                 TYPE_AU1, TYPE_AU2, TYPE_AU3}


class _BitReader:
    """MSB-first bit reader (shorten packs bits into big-endian 32-bit
    words, which over the byte stream is plain MSB-first byte order)."""

    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.ones = np.flatnonzero(self.bits)  # for fast unary scans
        self.pos = 0

    def take(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        self.pos = p + n
        chunk = self.bits[p : p + n]
        if chunk.size < n:
            raise ValueError("shorten: truncated bitstream")
        val = 0
        for b in chunk:
            val = (val << 1) | int(b)
        return val

    def unary(self) -> int:
        """Count of 0-bits before the next 1-bit; consumes the 1-bit."""
        i = np.searchsorted(self.ones, self.pos)
        if i >= self.ones.size:
            raise ValueError("shorten: truncated bitstream (unary)")
        stop = int(self.ones[i])
        q = stop - self.pos
        self.pos = stop + 1
        return q

    def uvar(self, k: int) -> int:
        return (self.unary() << k) | self.take(k)

    def var(self, k: int) -> int:
        u = self.uvar(k + 1)
        return (u >> 1) ^ -(u & 1)  # == -(u>>1)-1 when odd

    def ulong(self) -> int:
        return self.uvar(self.uvar(ULONGSIZE))


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nacc = 0

    def put(self, val: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((val >> i) & 1)
            self.nacc += 1
            if self.nacc == 8:
                self.out.append(self.acc)
                self.acc = 0
                self.nacc = 0

    def unary(self, q: int) -> None:
        for _ in range(q):
            self.put(0, 1)
        self.put(1, 1)

    def uvar(self, val: int, k: int) -> None:
        self.unary(val >> k)
        self.put(val & ((1 << k) - 1), k)

    def var(self, val: int, k: int) -> None:
        u = (val << 1) if val >= 0 else ((-val - 1) << 1) | 1
        self.uvar(u, k + 1)

    def ulong(self, val: int) -> None:
        k = max(val.bit_length(), 0)
        # any k works; shorten uses the minimal-ish width
        self.uvar(k, ULONGSIZE)
        self.uvar(val, k)

    def getvalue(self) -> bytes:
        while self.nacc:
            self.put(0, 1)
        while len(self.out) % 4:  # pad to a 32-bit word like shorten
            self.out.append(0)
        return bytes(self.out)


def _ulaw_to_linear(u: np.ndarray) -> np.ndarray:
    """G.711 u-law byte -> linear 16-bit (sph2pipe's ulaw2pcm table math)."""
    u = (~u.astype(np.int32)) & 0xFF
    sign = u & 0x80
    exp = (u >> 4) & 0x07
    mant = u & 0x0F
    mag = ((mant << 3) + 0x84) << exp
    lin = mag - 0x84
    return np.where(sign, -lin, lin).astype(np.int16)


def _alaw_to_linear(a: np.ndarray) -> np.ndarray:
    a = a.astype(np.int32) ^ 0x55
    sign = a & 0x80
    exp = (a >> 4) & 0x07
    mant = a & 0x0F
    mag = np.where(exp == 0, (mant << 4) + 8, ((mant << 4) + 0x108) << (exp - 1))
    return np.where(sign, -mag, mag).astype(np.int16)


def _rounded_shift_down(x: int, n: int) -> int:
    return x if n == 0 else ((x >> (n - 1)) + 1) >> 1


def _cdiv(a: int, b: int) -> int:
    """C integer division: truncates toward zero (shorten.c computes the
    nmean offsets with plain C ``/`` on longs, which differs from Python's
    floor ``//`` whenever the block sum is negative)."""
    q = abs(a) // b
    return q if (a >= 0) == (b >= 0) else -q


def decode_shorten(data: bytes, max_samples: int | None = None) -> tuple:
    """Decode a shorten stream -> (samples int32 array [n, nchan] squeezed
    to 1-D for mono, ftype).  u-law/A-law payloads are expanded to linear
    16-bit; 16-bit types are returned in their natural signed range."""
    if data[:4] != MAGIC:
        raise ValueError("not a shorten stream (bad magic)")
    version = data[4]
    if version > 3:
        raise ValueError(f"unsupported shorten version {version}")
    br = _BitReader(data[5:])

    def uint_get(k: int) -> int:
        return br.uvar(k) if version == 0 else br.ulong()

    ftype = uint_get(TYPESIZE)
    nchan = uint_get(CHANSIZE)
    blocksize = DEFAULT_BLOCK_SIZE
    maxnlpc = 0
    nmean = 0
    if version > 0:
        blocksize = uint_get(int(np.log2(DEFAULT_BLOCK_SIZE)))
        maxnlpc = uint_get(LPCQSIZE)
        nmean = uint_get(0)
        nskip = uint_get(NSKIPSIZE)
        for _ in range(nskip):
            br.uvar(XBYTESIZE)
    nwrap = max(NWRAP, maxnlpc)
    lpcqoffset = (1 << LPCQUANT) // 2 if version > 1 else 0

    if ftype in (TYPE_AU1, TYPE_AU2, TYPE_AU3):
        raise ValueError(f"shorten ftype {ftype} (AU lossy) not supported")
    mean0 = {TYPE_U8: 0x80, TYPE_U16HL: 0x8000, TYPE_U16LH: 0x8000}.get(
        ftype, 0)
    offsets = [[mean0] * max(1, nmean) for _ in range(nchan)]
    # per-channel buffer with nwrap history slots at the front
    bufs = [np.zeros(nwrap + blocksize, np.int64) for _ in range(nchan)]
    out = [[] for _ in range(nchan)]
    bitshift = 0
    chan = 0
    while True:
        cmd = br.uvar(FNSIZE)
        if cmd == FN_QUIT:
            break
        if cmd == FN_BLOCKSIZE:
            new_bs = uint_get(max(int(blocksize).bit_length() - 1, 0))
            if new_bs > blocksize:
                raise ValueError("shorten: blocksize grew mid-stream")
            blocksize = new_bs
            for c in range(nchan):
                bufs[c] = np.concatenate(
                    [bufs[c][:nwrap], np.zeros(blocksize, np.int64)])
            continue
        if cmd == FN_BITSHIFT:
            bitshift = br.uvar(BITSHIFTSIZE)
            continue
        if cmd == FN_VERBATIM:
            count = br.uvar(VERBATIM_CKSIZE_SIZE)
            for _ in range(count):
                br.uvar(VERBATIM_BYTE_SIZE)
            continue
        if cmd not in (FN_ZERO, FN_DIFF0, FN_DIFF1, FN_DIFF2, FN_DIFF3,
                       FN_QLPC):
            raise ValueError(f"shorten: unknown command {cmd}")

        buf = bufs[chan]
        hist = buf[:nwrap]
        nblock = blocksize
        resn = 0
        if cmd != FN_ZERO:
            resn = br.uvar(ENERGYSIZE)
            if version == 0:
                resn -= 1
        # channel offset (v2: means are stored <<bitshift, rounded back)
        cbuf = offsets[chan]
        if nmean == 0:
            coffset = cbuf[0]
        else:
            s = (0 if version < 2 else nmean // 2) + sum(cbuf)
            coffset = (_cdiv(s, nmean) if version < 2
                       else _rounded_shift_down(_cdiv(s, nmean), bitshift))

        if cmd == FN_ZERO:
            block = np.zeros(nblock, np.int64)
        elif cmd == FN_QLPC:
            nlpc = br.uvar(LPCQSIZE)
            qlpc = [br.var(LPCQUANT) for _ in range(nlpc)]
            work = np.empty(nlpc + nblock, np.int64)
            work[:nlpc] = (hist[nwrap - nlpc:] - coffset) if nlpc else hist[:0]
            for i in range(nblock):
                s = lpcqoffset
                for j in range(nlpc):
                    s += qlpc[j] * int(work[nlpc + i - j - 1])
                work[nlpc + i] = br.var(resn) + (s >> LPCQUANT)
            block = work[nlpc:] + coffset
        else:
            res = np.array([br.var(resn) for _ in range(nblock)], np.int64)
            if cmd == FN_DIFF0:
                block = res + coffset
            elif cmd == FN_DIFF1:
                block = np.cumsum(res) + hist[-1]
            elif cmd == FN_DIFF2:
                # 2nd-order integrate: d1[i]=buf[i]-buf[i-1]
                d1 = np.cumsum(res) + (hist[-1] - hist[-2])
                block = np.cumsum(d1) + hist[-1]
            else:  # FN_DIFF3
                d2 = np.cumsum(res) + (hist[-1] - 2 * hist[-2] + hist[-3])
                d1 = np.cumsum(d2) + (hist[-1] - hist[-2])
                block = np.cumsum(d1) + hist[-1]

        # store the running mean (pre-bitshift domain, v2 stores <<bitshift)
        if nmean > 0:
            s = (0 if version < 2 else nblock // 2) + int(block.sum())
            cbuf.pop(0)
            m = _cdiv(s, nblock)
            if version >= 2 and bitshift > 0:
                m <<= bitshift
            cbuf.append(m)
        # wrap pre-shift history, then output the shifted block
        buf[:nwrap] = np.concatenate([hist, block])[-nwrap:]
        out[chan].append(block << bitshift if bitshift else block)
        chan = (chan + 1) % nchan
        if max_samples is not None and chan == 0:
            if sum(b.size for b in out[0]) >= max_samples:
                break

    chans = [np.concatenate(o) if o else np.zeros(0, np.int64) for o in out]
    n = min(c.size for c in chans)
    samples = np.stack([c[:n] for c in chans], axis=1)
    if ftype == TYPE_ULAW:
        samples = _ulaw_to_linear(samples).astype(np.int32)
    elif ftype == TYPE_ALAW:
        samples = _alaw_to_linear(samples).astype(np.int32)
    elif ftype in (TYPE_U16HL, TYPE_U16LH):
        samples = (samples - 0x8000).astype(np.int32)
    elif ftype == TYPE_U8:
        samples = ((samples - 0x80) << 8).astype(np.int32)
    elif ftype == TYPE_S8:
        samples = (samples << 8).astype(np.int32)
    else:
        samples = samples.astype(np.int32)
    if nchan == 1:
        samples = samples[:, 0]
    if max_samples is not None:
        samples = samples[:max_samples]
    return samples, ftype


def encode_shorten(
    samples: np.ndarray,
    ftype: int = TYPE_S16LH,
    blocksize: int = DEFAULT_BLOCK_SIZE,
    nmean: int = 0,
    version: int = 2,
) -> bytes:
    """Minimal shorten v2 encoder (mono, DIFF0-3 predictors, no LPC) for
    fixtures and roundtrip tests.  Picks the cheapest DIFF order per block
    like the reference encoder's heuristic."""
    if version != 2:
        raise ValueError(f"the encoder emits v2 streams only, not v{version}")
    x = np.asarray(samples, np.int64)
    if ftype in (TYPE_U16HL, TYPE_U16LH):
        x = x + 0x8000
    bw = _BitWriter()
    bw.ulong(ftype)
    bw.ulong(1)  # nchan
    bw.ulong(blocksize)
    bw.ulong(0)  # maxnlpc
    bw.ulong(nmean)
    bw.ulong(0)  # nskip
    mean0 = 0x8000 if ftype in (TYPE_U16HL, TYPE_U16LH) else (
        0x80 if ftype == TYPE_U8 else 0)
    cbuf = [mean0] * max(1, nmean)
    hist = np.zeros(NWRAP, np.int64)
    for start in range(0, len(x), blocksize):
        block = x[start : start + blocksize]
        nblock = block.size
        if nblock != blocksize:
            bw.uvar(FN_BLOCKSIZE, FNSIZE)
            bw.ulong(nblock)
            blocksize = nblock
        if nmean == 0:
            coffset = cbuf[0]
        else:
            s = nmean // 2 + sum(cbuf)
            coffset = _rounded_shift_down(_cdiv(s, nmean), 0)
        prev = np.concatenate([hist, block])
        cands = {
            FN_DIFF0: block - coffset,
            FN_DIFF1: np.diff(prev, 1)[NWRAP - 1:],
            FN_DIFF2: np.diff(prev, 2)[NWRAP - 2:],
            FN_DIFF3: np.diff(prev, 3)[NWRAP - 3:],
        }
        cmd = min(cands, key=lambda c: np.abs(cands[c]).sum())
        res = cands[cmd]
        if not np.any(block) and coffset == 0:
            bw.uvar(FN_ZERO, FNSIZE)
        else:
            mean_abs = max(float(np.abs(res).mean()), 1.0)
            resn = max(int(np.ceil(np.log2(mean_abs))) + 1, 0)
            bw.uvar(cmd, FNSIZE)
            bw.uvar(resn, ENERGYSIZE)
            for r in res:
                bw.var(int(r), resn)
        if nmean > 0:
            s = nblock // 2 + int(block.sum())
            cbuf.pop(0)
            cbuf.append(_cdiv(s, nblock))
        hist = prev[-NWRAP:]
    bw.uvar(FN_QUIT, FNSIZE)
    return MAGIC + bytes([version]) + bw.getvalue()
