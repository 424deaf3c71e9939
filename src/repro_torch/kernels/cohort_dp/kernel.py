"""Launchers of the cohort clip+noise kernels (``csrc/cohort_dp.cu``).

Replace the reference's Pallas kernels of
``repro/kernels/cohort_dp/kernel.py``:

* ``cohort_clip_noise_kernel`` <- ``_row_sqsum`` +
  ``cohort_clip_noise_kernel`` (noise from an operand);
* ``cohort_clip_noise_prng_kernel`` <- ``cohort_clip_noise_prng_kernel``
  (noise generated in the kernel from a counter-based threefry stream
  keyed by the tick's noise key).

Per-row clip, Gaussian noise and, when ``with_agg`` is set, the
weighted sum over clients; see the source's note for the design.
``prng_words_probe`` returns the generator's raw words, so a check can
hold the stream itself against ``repro_torch.prng``; it is a probe, not
a kernel of the engine's path, and is not counted.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels.launches import LAUNCHES

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U, _LL = ctypes.c_uint32, ctypes.c_longlong
_lib = None


def _dp():
    global _lib
    if _lib is None:
        lib = _build.load("cohort_dp")
        lib.dp_blocks.argtypes = [_I]
        lib.dp_clip_noise.argtypes = [_P] * 8 + [_I, _I, _F, _F, _P]
        lib.dp_clip_noise_prng.argtypes = ([_P, _U, _U, _LL] + [_P] * 6
                                           + [_I, _I, _F, _F, _P])
        lib.dp_prng_words.argtypes = [_U, _U, _LL, _P, _P, _P]
        for fn in (lib.dp_blocks, lib.dp_clip_noise, lib.dp_clip_noise_prng,
                   lib.dp_prng_words):
            fn.restype = _I
        _lib = lib
    return _lib


def _buffers(lib, u, clip: float, with_agg: bool):
    """out [C, D]; agg [D] and its row-block partials when asked for;
    the row scales [C] when clip > 0.  Pointers are None where absent."""
    C, D = u.shape
    dev = u.device
    out = torch.empty_like(u)
    agg = partial = scale = None
    if with_agg:
        agg = torch.empty((D,), dtype=torch.float32, device=dev)
        partial = torch.empty((lib.dp_blocks(C), D), dtype=torch.float32,
                              device=dev)
    if clip > 0.0:
        scale = torch.empty((C,), dtype=torch.float32, device=dev)
    ptrs = [None if t is None else t.data_ptr()
            for t in (out, agg, partial, scale)]
    return out, agg, ptrs


def cohort_clip_noise_kernel(u, noise, weights, mask, *, clip: float,
                             noise_scale: float, with_agg: bool = True):
    """u [C, D] f32; noise [C, D] f32 (None when noise_scale <= 0);
    weights, mask [C] f32 -> (out [C, D], agg [D] or None)."""
    C, D = u.shape
    dev = u.device
    _build.need(u, "u", torch.float32, (C, D), dev)
    if noise_scale > 0.0:
        _build.need(noise, "noise", torch.float32, (C, D), dev)
    _build.need(weights, "weights", torch.float32, (C,), dev)
    _build.need(mask, "mask", torch.float32, (C,), dev)
    lib = _dp()
    out, agg, ptrs = _buffers(lib, u, clip, with_agg)
    _build.check(lib.dp_clip_noise(
        u.data_ptr(), noise.data_ptr() if noise_scale > 0.0 else None,
        mask.data_ptr(), weights.data_ptr(), *ptrs, C, D, float(clip),
        float(noise_scale), _build.stream(dev)), "cohort_clip_noise")
    LAUNCHES["cohort_clip_noise"] += 1
    return out, agg


def key_words(key):
    """A CPU key ``[2]`` -> its two uint32 words as Python ints (kernel
    scalars: passing them costs no copy)."""
    if key.device.type != "cpu" or tuple(key.shape) != (2,):
        raise ValueError("the noise key is one [2] key on the CPU")
    k0, k1 = key.tolist()
    return int(k0), int(k1)


def cohort_clip_noise_prng_kernel(u, key, weights, mask, *, clip: float,
                                  noise_scale: float, with_agg: bool = True,
                                  row_offset: int = 0):
    """u [C, D] f32; key [2] CPU int64 (two uint32 words); weights, mask
    [C] f32 -> (out [C, D], agg [D] or None), the normals generated in
    the kernel from the counter stream of ``key``, u's row 0 being row
    ``row_offset`` of the draw."""
    C, D = u.shape
    dev = u.device
    _build.need(u, "u", torch.float32, (C, D), dev)
    _build.need(weights, "weights", torch.float32, (C,), dev)
    _build.need(mask, "mask", torch.float32, (C,), dev)
    k0, k1 = key_words(key)
    lib = _dp()
    out, agg, ptrs = _buffers(lib, u, clip, with_agg)
    _build.check(lib.dp_clip_noise_prng(
        u.data_ptr(), k0, k1, int(row_offset) * D, mask.data_ptr(),
        weights.data_ptr(), *ptrs,
        C, D, float(clip), float(noise_scale), _build.stream(dev)),
        "cohort_clip_noise_prng")
    LAUNCHES["cohort_clip_noise_prng"] += 1
    return out, agg


def prng_words_probe(key, n: int, device):
    """The kernel's counter stream for flat indices ``0 .. n - 1``: both
    threefry output words as int64 tensors of uint32 values."""
    k0, k1 = key_words(key)
    w0 = torch.empty((n,), dtype=torch.int32, device=device)
    w1 = torch.empty((n,), dtype=torch.int32, device=device)
    _build.check(_dp().dp_prng_words(k0, k1, n, w0.data_ptr(), w1.data_ptr(),
                                     _build.stream(device)), "dp_prng_words")
    mask = 0xFFFFFFFF
    return w0.to(torch.int64) & mask, w1.to(torch.int64) & mask
