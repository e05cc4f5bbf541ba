"""Build-and-load of the package's CUDA sources, and the host-side helpers
that the op modules share.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is compiled
with nvcc for ``sm_90a`` into ``csrc/build/lib<name>-<digest>.so`` (the digest
covers the source, the headers it includes and the flags, so a changed source
rebuilds) and loaded with ctypes.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


# the serial backward kernels' branches, as their launchers number them
# (csrc/bwd_hoist.cuh BwdBranch): the cooperative grid, the bf16 tensor-core
# clusters of 16 or 32 batch rows, the fp32 cluster of 16 rows, and the
# wide-batch fp32 branch (csrc/bwd_wide.cuh: one CTA an SM, 3xTF32 on the
# tensor cores, the partial dh exchanged through L2 under step flags)
BRANCHES = ("grid", "cluster16", "cluster32", "cluster16_fp32", "wide_fp32")
# the forward kernels' branches (csrc/fwd_cluster.cuh FwdBranch), which the
# tanh cell's backward takes too: the cooperative grid, the bf16
# tensor-core clusters of 16 or 32 batch rows, the fp32 cluster of 16
# rows, and the wide-batch branch (csrc/fwd_wide.cuh: one CTA an SM, h
# exchanged through L2 under step flags) with fp32 products (3xTF32 on the
# tensor cores) and with bf16 products (the gated cells on bf16 streams past
# the bf16 clusters: bf16 mma.sync, h exchanged as bf16)
FWD_BRANCHES = ("grid", "cluster16", "cluster32", "cluster16_fp32",
                "wide_fp32", "wide_bf16")


def wide_scratch_sizes(b: int, h: int, ndir: int,
                       bf16: bool = False) -> Tuple[int, int]:
    """``(elements, ints)`` of the wide branch's scratch
    (``csrc/fwd_wide.cuh`` ``wide_hx_floats``, ``wide_hx_bf16``,
    ``wide_flag_ints``): the exchange buffer, two steps of h in the mma's
    fragment order over B and H rounded up to 16 and 8 (fp32; ``bf16``, the
    bf16 products' buffer: H rounded up to 16), and one step flag per
    (direction, 16 rows, 8 units)."""
    mt, kb = -(-b // 16), -(-h // 8)
    unit = 16 * -(-kb // 2) if bf16 else 8 * kb
    return 2 * ndir * 16 * mt * unit, ndir * mt * kb


def launch_forward(lib, prefix: str, gx, w, outs, t_len: int, b: int, h: int,
                   ndir: int, scratch_shapes) -> str:
    """Launch the forward entry ``<prefix>_forward`` of a recurrence library
    on the current stream with ``outs`` (``ys``, and the LSTM training
    forward's ``cs``) and two scratch pointers after them: asks
    ``<prefix>_fwd_branch`` first and makes the grid branch's zeroed fp32
    scratch (the h double buffer ``(ndir, 2, H, ldh)``, then
    ``scratch_shapes``, at most one, else a null pointer) only for it, and
    the wide branches' exchange buffer (fp32, or bf16 for ``wide_bf16``)
    and step flags (``wide_scratch_sizes``; the library zeroes the flags on
    the stream) only for those.  Returns the branch launched (``FWD_BRANCHES``);
    raises if the launch failed."""
    import torch

    bf16 = int(gx.dtype == torch.bfloat16)
    branch = ctypes.c_int(-1)
    err = getattr(lib, f"{prefix}_fwd_branch")(b, h, ndir, bf16,
                                               ctypes.byref(branch))
    ldh = -(-b // 4) * 4  # rows of the grid's h buffer, 16-byte pieces
    ptrs = [None, None]
    if err == 0 and FWD_BRANCHES[branch.value] == "grid":
        scratch = [torch.zeros(ndir, 2, h, ldh, dtype=torch.float32,
                               device=gx.device)]
        scratch += [torch.zeros(*s, dtype=torch.float32, device=gx.device)
                    for s in scratch_shapes]
        ptrs = [x.data_ptr() for x in scratch] + [None] * (2 - len(scratch))
    elif err == 0 and FWD_BRANCHES[branch.value].startswith("wide"):
        wide_bf16 = FWD_BRANCHES[branch.value] == "wide_bf16"
        n_hx, n_flags = wide_scratch_sizes(b, h, ndir, wide_bf16)
        scratch = [torch.empty(n_hx, device=gx.device, dtype=torch.bfloat16
                               if wide_bf16 else torch.float32),
                   torch.empty(n_flags, dtype=torch.int32, device=gx.device)]
        ptrs = [x.data_ptr() for x in scratch]
    if err == 0:
        stream = torch.cuda.current_stream(gx.device).cuda_stream
        err = getattr(lib, f"{prefix}_forward")(
            gx.data_ptr(), w.data_ptr(), *[o.data_ptr() for o in outs], *ptrs,
            t_len, b, h, ldh, ndir, bf16, stream, ctypes.byref(branch))
    if err != 0:
        msg = getattr(lib, f"{prefix}_error_string")(err).decode()
        raise RuntimeError(f"{prefix} forward kernel launch failed ({err}: "
                           f"{msg}) at T={t_len} B={b} H={h}")
    return FWD_BRANCHES[branch.value]


def serial_scratch(lib, prefix: str, branch: str, b: int, h: int, ndir: int,
                   dp_rows: int, device) -> list:
    """The scratch of a backward serial launch ``<prefix>_backward`` on
    ``branch`` (``BRANCHES``), as the entry takes it after ``dgx`` (and the
    GRU's ``dhhn``): the grid's zeroed fp32 dpre double buffer ``(ndir, 2,
    dp_rows, ldh)`` and dh scratch ``(ndir, B, H)`` (the LSTM passes a dc
    scratch of that shape too, after them); the wide branch's exchange
    buffer and step flags, sized by ``<prefix>_bwd_wide_scratch`` (the
    library zeroes the flags on the stream); nothing for the clusters."""
    import torch

    if branch == "grid":
        ldh = -(-b // 4) * 4
        return [torch.zeros(ndir, 2, dp_rows, ldh, dtype=torch.float32,
                            device=device),
                torch.zeros(ndir, b, h, dtype=torch.float32, device=device)]
    if branch == "wide_fp32":
        n_x, n_flags = ctypes.c_size_t(0), ctypes.c_size_t(0)
        err = getattr(lib, f"{prefix}_bwd_wide_scratch")(
            b, h, ndir, ctypes.byref(n_x), ctypes.byref(n_flags))
        if err != 0 or n_x.value == 0:
            msg = getattr(lib, f"{prefix}_error_string")(err).decode()
            raise RuntimeError(f"{prefix} wide backward has no scratch ({err}: "
                               f"{msg}) at B={b} H={h}")
        return [torch.empty(n_x.value, dtype=torch.float32, device=device),
                torch.empty(n_flags.value, dtype=torch.int32, device=device)]
    return []


def device_kind(t, what: str) -> str:
    """``"cuda"`` or ``"cpu"`` for a tensor: the ops launch their kernel for
    the first and run the plain twin for the second; any other device raises."""
    if t.is_cuda:
        return "cuda"
    if t.device.type == "cpu":
        return "cpu"
    raise ValueError(f"{what}: unsupported device {t.device}")


def acc_dtype(dtype):
    """dtype of a recurrence's carries and gate math: fp32 for the fp32 and
    bf16 streams (float64 streams stay float64, for numerical gradient checks
    of the plain twins)."""
    import torch

    return torch.float64 if dtype == torch.float64 else torch.float32


def check_recurrence(gx, w_hh, gates: int) -> Tuple[int, int, int, int]:
    """``(T, B, H, ndir)`` of a recurrence kernel's inputs, or raise: ``gx (T,
    B, ndir * gates * H)`` fp32 or bf16 and ``w_hh (ndir, H, gates * H)``
    fp32 on the same device, ``ndir`` 1 or 2, T and B at least 1."""
    import torch

    t_len, b, lanes = gx.shape
    ndir, h = w_hh.shape[0], w_hh.shape[1]
    if gx.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gx must be float32 or bfloat16, got {gx.dtype}")
    if (w_hh.dtype != torch.float32 or ndir not in (1, 2)
            or tuple(w_hh.shape) != (ndir, h, gates * h)):
        raise ValueError(f"w_hh must be fp32 (ndir in (1, 2), H, {gates}H), "
                         f"got {w_hh.dtype} {tuple(w_hh.shape)}")
    if lanes != ndir * gates * h or t_len < 1 or b < 1:
        raise ValueError(f"gx must be (T>=1, B>=1, {ndir * gates * h}), got "
                         f"{tuple(gx.shape)}")
    if w_hh.device != gx.device:
        raise ValueError("gx and w_hh must be on the same device")
    return t_len, b, h, ndir


def check_plane(name: str, plane, gx, lanes: int) -> None:
    """Raise unless a saved or incoming plane of a backward kernel is ``(T, B,
    lanes)`` in ``gx``'s dtype on ``gx``'s device."""
    want = (gx.shape[0], gx.shape[1], lanes)
    if (plane.dtype != gx.dtype or plane.device != gx.device
            or tuple(plane.shape) != want):
        raise ValueError(f"{name} must be {gx.dtype} {want} on {gx.device}, "
                         f"got {plane.dtype} {tuple(plane.shape)} on "
                         f"{plane.device}")


def check_serial(planes, w_hh, dy, n_planes: int, gates: int
                 ) -> Tuple[int, int, int, int]:
    """``(ndir, T, B, H)`` of a serial backward kernel's inputs, or raise:
    the pre-pass planes ``(ndir, T, n_planes, B, H)`` fp32, ``w_hh (ndir, H,
    gates * H)`` fp32 and ``dy (T, B, ndir * H)`` fp32 or bf16, on one
    device."""
    import torch

    ndir, t_len, n, b, h = planes.shape
    if (planes.dtype != torch.float32 or n != n_planes
            or w_hh.dtype != torch.float32
            or tuple(w_hh.shape) != (ndir, h, gates * h)
            or dy.dtype not in (torch.float32, torch.bfloat16)
            or tuple(dy.shape) != (t_len, b, ndir * h)
            or not planes.device == w_hh.device == dy.device):
        raise ValueError(
            f"want planes fp32 (ndir, T, {n_planes}, B, H), w_hh fp32 (ndir, "
            f"H, {gates}H) and dy (T, B, ndir * H) on one device, got "
            f"{tuple(planes.shape)}, {tuple(w_hh.shape)}, {tuple(dy.shape)}")
    return ndir, t_len, b, h


def step_times(t_len: int, ndir: int, s: int) -> Tuple[int, ...]:
    """Forward-time index of each direction at step ``s`` of a recurrence's
    forward walk: direction 0 at ``s``, direction 1 at ``T - 1 - s``.  The
    backward walk's step ``s`` is the forward walk's step ``T - 1 - s``."""
    return (s, t_len - 1 - s)[:ndir]


def per_direction(plane, ndir: int):
    """``(ndir, T, B, lanes)`` view of a ``(T, B, ndir * lanes)`` plane."""
    t_len, b, lanes = plane.shape
    return plane.reshape(t_len, b, ndir, lanes // ndir).permute(2, 0, 1, 3)


def shifted(plane, ndir: int, acc):
    """``(ndir, T, B, H)`` in ``acc`` of a ``(T, B, ndir * H)`` plane one step
    earlier in each direction's forward walk: ``plane[t - 1]`` for direction
    0, ``plane[t + 1]`` for direction 1, zero outside (h_prev and c_prev of
    step t)."""
    import torch

    src = per_direction(plane, ndir).to(acc)
    out = torch.zeros_like(src)
    out[0, 1:] = src[0, :-1]
    if ndir == 2:
        out[1, :-1] = src[1, 1:]
    return out


def prepass_weights(w_hh, dtype):
    """The backward pre-pass kernels' weight operand: with bf16 streams
    ``w_hh^T (ndir, nH, H)`` in bf16 (its rows stage as the product's B
    operand), else ``w_hh (ndir, H, nH)`` fp32; rounded to the stream dtype
    either way."""
    import torch

    if dtype == torch.bfloat16:
        return w_hh.to(dtype).transpose(1, 2).contiguous()
    return w_hh.to(dtype).float().contiguous()


def padded_planes(planes) -> Tuple[object, int]:
    """``(buffer, Hp)``: the backward's factor planes ``(ndir, T, P, B, H)``
    fp32 as the serial kernels read them, contiguous with rows of ``Hp`` (H
    rounded up to a multiple of 4, for 16-byte loads); copied unless they
    are already so."""
    import torch

    h = planes.shape[-1]
    hp = -(-h // 4) * 4
    if hp == h and planes.is_contiguous():
        return planes, hp
    buf = torch.zeros(*planes.shape[:-1], hp, dtype=torch.float32,
                      device=planes.device)
    buf[..., :h] = planes
    return buf, hp


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/*.cu at first use on a CUDA machine")


class KernelLibrary:
    """One ``.cu`` source, its build and its loaded ``ctypes.CDLL``.

    ``functions`` maps each exported name to ``(argtypes, restype)``;
    ``headers`` are the ``csrc/`` files the source includes."""

    def __init__(self, source: str, functions: Dict[str, Tuple[list, object]],
                 headers: Sequence[str] = ()):
        self.source = CSRC / source
        self.headers = [CSRC / h for h in headers]
        self.functions = functions
        self.build_log = ""  # nvcc's output (registers, shared memory, spills)
        self._lib: Optional[ctypes.CDLL] = None

    def output_path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in (self.source, *self.headers):
            h.update(path.read_bytes())
        return BUILD_DIR / f"lib{self.source.stem}-{h.hexdigest()[:12]}.so"

    def build_command(self, out: Path) -> list:
        return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(self.source)]

    def build(self) -> Path:
        """Compile the source (once per version); the library's path."""
        build_all([self])
        return self.output_path()

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for name, (argtypes, restype) in self.functions.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            self._lib = lib
        return self._lib


def build_all(libraries: Sequence[KernelLibrary]) -> None:
    """Build the sources that have no library yet, one nvcc process each,
    all started together."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for lib in libraries:
        out = lib.output_path()
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        running.append((lib, out, tmp, subprocess.Popen(
            lib.build_command(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failures = []
    for lib, out, tmp, proc in running:  # reap every compiler before raising
        lib.build_log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {lib.source}:\n{lib.build_log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    if failures:
        raise RuntimeError("\n".join(failures))
